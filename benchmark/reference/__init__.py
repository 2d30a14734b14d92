"""The plain reference the benchmark judges the program's answers by.

NumPy and plain PyTorch only. Nothing here imports the program under test
or JAX, and nothing here takes a value the program made: the benchmark
hands both sides the same inputs, and the reference works out again what
the program derives from them.
"""
