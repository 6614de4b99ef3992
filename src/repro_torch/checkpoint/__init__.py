"""Checkpoint I/O (msgpack envelopes of tensor trees) and the
Weibull-interval checkpoint manager."""
