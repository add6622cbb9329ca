"""Plain references that the benchmark's comparison holds the program to."""
