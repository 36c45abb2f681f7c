"""CSR helpers shared by the index structures."""
