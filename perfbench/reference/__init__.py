"""Plain references that the benchmark holds the program to; they import nothing of it."""
