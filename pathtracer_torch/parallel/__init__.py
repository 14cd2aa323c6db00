"""Multi-device rendering (counterpart of pathtracer/parallel/)."""
