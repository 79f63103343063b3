"""Device steps of the port (``runtime/executor.py``): training and the
paged serving steps."""
