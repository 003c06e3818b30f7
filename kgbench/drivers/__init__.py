"""One driver a kind of traffic, named by the mix's ``driver``."""
