"""The plain reference of the benchmark: it imports nothing of the program."""
