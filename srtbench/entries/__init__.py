"""Entries: how a traffic mix drives the port, one module each, found by
the ``entry`` name in the traffic file."""
