"""Plain PyTorch references: no kernel, no import of the program under test."""
