"""Plain float32 reference of what the benchmark checks; imports nothing of the program."""
