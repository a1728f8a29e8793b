"""Dataset readers of the port (numpy and the standard library; PIL for the image files)."""
