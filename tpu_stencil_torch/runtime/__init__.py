"""Runtime services of the port: roofline, autotuner, benchmark sweep."""
