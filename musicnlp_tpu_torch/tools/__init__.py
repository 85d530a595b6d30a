"""Tools run on the card (counterpart of the JAX package's scripts/)."""
