"""Device-route operations of the PyTorch port: host-side helpers
(``host``), plain tensor code (``scan_torch``), the CUDA kernels and their
wrappers (``scan_cuda``), their build (``_build``) and the backend probe
(``probe``)."""
