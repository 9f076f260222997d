"""Model families of the port (Llama so far)."""
