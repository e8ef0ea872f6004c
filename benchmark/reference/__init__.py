"""The benchmark's plain reference, independent of the program."""
