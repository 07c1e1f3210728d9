"""Device ops: the CUDA connected-components chain (``ops.cc``, sources in
``csrc/``) and the host geometry library (``ops.geometry``)."""
