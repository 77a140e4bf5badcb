"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``);
the ``gpu`` ones run on the card."""
