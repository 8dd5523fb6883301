"""The plain reference the benchmark holds the program to: plain PyTorch
and numpy, no import of the program and nothing the program made.
``train.py`` trains any model; ``<model>.py`` holds one model's layers,
found by the configuration's ``model``."""
