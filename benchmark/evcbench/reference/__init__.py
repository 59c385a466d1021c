"""The plain reference that decides `correct`: frozen copies of the
port's decoder and of its fused analysis graph.  It imports nothing of
the program."""
