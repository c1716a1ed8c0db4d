"""ColBERT configurations of the port."""
