"""Device operations of the port: ``device_huf``, ``device_fse`` and
``histogram`` each hold a CUDA kernel's wrapper beside its plain torch
version; ``execseq``, ``common``, ``matcher`` and ``device_encode`` are
plain torch."""
