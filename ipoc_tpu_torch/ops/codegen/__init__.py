"""Model code generation: torch model definitions as straight-line kernel
code (``scalarize``)."""
