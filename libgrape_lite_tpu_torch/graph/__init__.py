"""Host-side padded CSR."""
