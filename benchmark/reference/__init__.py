"""The plain reference the program's answers are judged against (net.py)
and the comparison that decides `correct` (compare.py).  Plain PyTorch
only: nothing here imports the program."""
