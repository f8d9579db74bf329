"""Plain references of the benchmark: f64 PyTorch on the same operand,
computed in row blocks so that they fit beside it.  They import nothing
of the port, of JAX or of the JAX package, and take nothing the program
made: the operand is made again from the seed (``portbench/operands.py``)
and what the program's set-up derived from it (int8 rows, CSR pairs) is
worked out again here.
"""
