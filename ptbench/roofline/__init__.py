"""Rooflines: the device's peaks and the work each kernel's inputs need."""
