"""Host utilities of the port (the plain-brotli comparison codec, the
corpus recipe)."""
