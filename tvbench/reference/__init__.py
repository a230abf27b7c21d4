"""The plain reference: Python and NumPy alone, nothing of the program."""
