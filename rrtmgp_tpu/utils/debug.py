"""Debug-mode helpers: the analogue of the reference's quality
gates (JET type-stability + allocation bounds + --check-bounds, see
/root/reference/test/clear_sky_utils.jl:88-99, test/datalayouts.jl:2).

JAX has no shared mutable state to race on (columns never exchange data, as
in the reference); the failure modes worth guarding are tracer leaks,
silent NaN production, and unintended retracing.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def strict_mode(nans: bool = True, leaks: bool = True):
    """Enable jit-leak checking and NaN debugging for the enclosed block."""
    import jax

    ctxs = []
    if leaks:
        ctxs.append(jax.checking_leaks())
    if nans:
        ctxs.append(jax.debug_nans(True))
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        yield


@contextlib.contextmanager
def assert_compiles_once(fn_name: str = ""):
    """Fail if the enclosed block triggers more than one trace of any jitted
    function — the analogue of the reference's zero-allocation hot-path
    guarantee (a retrace on every step is the JAX way to 'allocate')."""
    import jax

    log = []
    with jax.log_compiles(True):
        import logging

        handler = logging.Handler()
        handler.emit = lambda record: log.append(record.getMessage())
        logger = logging.getLogger("jax._src.dispatch")
        logger.addHandler(handler)
        try:
            yield log
        finally:
            logger.removeHandler(handler)
