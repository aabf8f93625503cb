"""The entries a window drives, named by a traffic mix's ``entry``."""
