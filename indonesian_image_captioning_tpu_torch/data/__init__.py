"""Dataset readers, the batch loader and the device image store."""
