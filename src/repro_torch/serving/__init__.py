"""Serving on the GPU: the batched inference engine."""
