"""Communication suite of the port over logical ranks on one card: the
ring engine, the library collectives, the device-initiated fused ring
kernels and the array-level :class:`~.communicator.Communicator`."""
