"""Data preparation scripts (counterparts of the repository's misc/)."""
