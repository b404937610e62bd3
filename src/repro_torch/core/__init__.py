"""CAMD core of the port: scoring (Eq. 7-12), clustering (Eq. 13),
posterior coverage and guidance (Eq. 14-16), and the round controller."""
