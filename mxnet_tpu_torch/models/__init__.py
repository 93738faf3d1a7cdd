"""Model definitions of the port as Symbols."""
