"""Per-method adapters, named by a configuration's ``method`` (the port's
``GLOBAL.METHOD_TYPE``): how to build the program's objects on the
benchmark's inputs, what a run records, and the reference's readings."""
