"""Device operations of the port: ``device_huf``, ``device_fse``,
``histogram`` and ``execseq`` each hold a CUDA kernel's wrapper beside its
plain torch version; ``common``, ``matcher``, ``device_encode`` and
``ldm`` are plain torch."""
