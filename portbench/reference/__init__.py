"""The plain reference: NumPy only, independent of the program."""
