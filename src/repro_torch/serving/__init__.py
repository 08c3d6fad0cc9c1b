"""Serving stack of the port: RNG, sampling, strategies, paged cache
bookkeeping, engine pieces and the paged scheduler."""
