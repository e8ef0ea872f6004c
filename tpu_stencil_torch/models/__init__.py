"""Models: the iterated stencil."""
