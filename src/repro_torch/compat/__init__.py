"""The port's mesh environment (``meshenv``)."""
