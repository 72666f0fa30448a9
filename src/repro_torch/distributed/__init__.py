"""Logical-axis sharding of the port's trees onto a ``DeviceMesh``."""
