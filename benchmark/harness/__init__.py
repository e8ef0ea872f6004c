"""The benchmark's general machinery: the files found by name, the seeded
inputs, the arrival law, the frozen work count, the traced window and one
run of a cell."""
