"""Multi-archive decode: static assignment of archives to processes, and
pooled batches of many archives' pages on one device."""
