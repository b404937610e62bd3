"""Placement rules of the port (``sharding``)."""
