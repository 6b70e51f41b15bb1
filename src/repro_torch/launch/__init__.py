"""Launchers of the port: LM serving (``serve``)."""
