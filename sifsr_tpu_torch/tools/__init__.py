"""Tools of the port, named after the repository's ``tools/``
(``tools.bf16_convergence``)."""
