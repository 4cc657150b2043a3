"""Probes of the card that are not part of the solver (counterparts of the
repository's ``tools/``)."""
