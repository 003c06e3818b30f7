"""The benchmark's own tests, apart from the repository's ``tests/``."""
