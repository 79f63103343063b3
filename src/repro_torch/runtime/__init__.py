"""Device steps of the port (``runtime/executor.py``): training, the
dense-cache serving and prefill steps, and the paged serving steps."""
