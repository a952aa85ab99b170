"""Model families: the block a configuration runs, one module a block.

A configuration file names its family by its published ``model_type``;
``core/registry.py::family`` loads ``families/<model_type>.py``. Nothing
else in the harness knows a block, so a configuration with a new block
adds a family file beside its configuration, cell and traffic files and
edits none that is there. A module whose name starts with ``_`` is a body
that families share, not a family.

A family module provides:

``shape(cfg)``
    The sizes the arithmetic needs, from the configuration file. The
    object has ``dtype`` (the served dtype's name), ``vocab``,
    ``body_params`` (matrix parameters a token passes below the head),
    ``head_params``, ``attn_flops(keys)`` (one query over ``keys``
    positions, every layer), ``flash_work(length)`` and
    ``decode_work(keys)`` ((operations, bytes) of a prompt's causal
    attention and of one decode step's attention over requests holding
    ``keys`` positions each), ``kv_bytes_per_token`` (the cache a position
    holds, every layer), and ``layout()``: every weight leaf as ``(path,
    shape, std, dtype)``, in tree order, which ``core/weights.py`` draws.
``logits(weights, cfg, seqs, rows, precision)``
    The plain reference: float32 PyTorch, nothing of the program (see
    ``core/reference.py::logits``).
``port_config(cfg)``
    The port's ``ModelConfig`` for the file. A setting the port cannot
    express is refused with ``ValueError``.
``engine_args(cfg)``
    Keyword arguments for the port's ``ServingEngine`` beyond those of the
    file's ``engine`` mapping.
``small(cfg)``
    The configuration with its widths cut to a size the CPU tests run in
    seconds (``tests/tiny.py``).

Only ``port_config`` and ``engine_args`` import the port, inside the
function.
"""
