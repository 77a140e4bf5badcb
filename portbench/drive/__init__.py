"""The loops that drive a cell's window, one module per traffic kind."""
