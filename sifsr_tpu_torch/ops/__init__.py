"""Host-side tensor operations of the port."""
