"""Data: for now only the image normalisation constants (data/preprocess.py)."""
