"""One driver a program entry: ``drivers/<traffic's driver>.py`` defines
``Driver``, which makes the cell's inputs, warms the entry up, calls it
once an input in the window, and hands the answers to ``benchmark.checks``.
"""
