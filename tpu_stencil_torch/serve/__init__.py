"""The serving layer of the port. Ported so far: :mod:`metrics`, the
registry the driver-side observability core keeps its counters and
histograms in; the engine, bucketing, load generator and ``serve``
subcommand come with the serving slice."""
