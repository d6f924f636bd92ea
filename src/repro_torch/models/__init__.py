"""Model classes and the architecture registry."""
