"""The plain NumPy reference that decides ``correct``; it imports nothing
of the program."""
