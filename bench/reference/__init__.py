"""The plain float32 reference that decides `correct`. It imports
nothing of the program under test."""
