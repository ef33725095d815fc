"""Record-batch encode plane of the port (``compress_batch_device``)."""
