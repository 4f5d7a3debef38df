"""Plain references, one file per kind of network, named by configurations."""
