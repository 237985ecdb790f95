"""Data pipelines of the port (numpy and threads; batches move to the device
in the training loop)."""
