"""The entries a cell's window drives, one module each, named by the
cell's ``entry``. A module's ``setup(bench)`` returns a run object with
``unit()`` (one closed-loop unit of work; returns its counts),
``release()`` (frees the program's state) and ``check()`` (the
comparison with the plain reference: [(name, value, limit)])."""
