"""Model families of the port (dense decoder LM so far)."""
