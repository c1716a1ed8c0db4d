"""Step builders of the port: the entry points of causal-LM serving."""
