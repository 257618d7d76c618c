"""Multi-device and multi-process decode: static assignment of archives to
processes, pooled batches of many archives' pages on one device, the
gathers across processes (runtime), and one stream's pages split over
several devices (sharding)."""
