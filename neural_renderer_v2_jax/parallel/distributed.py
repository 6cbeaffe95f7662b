"""Multi-process initialization and mesh construction.

The reference has no distributed runtime at all (SURVEY.md §2.2); this
module is the entry point for running the renderer from several
processes (one per host, or one per GPU): one `jax.distributed.initialize`
call per process, then a global mesh over every device.

Axis costs (see docs/SCALING.md for the communication model):
  * ``data``  -- batch/camera shards never communicate in the forward
    pass and only psum small vertex/texture grads.
  * ``tile``  -- image rows; forward is communication-free, backward
    needs 1-row halos (GSPMD ppermute) + grad psum.
  * ``face``  -- the resolve's face loop; the ordered z-combine
    all_gathers 2 planes per pixel band, the heaviest collective here.
    Across hosts, keep it within one host.

Typical use in each process:

    from neural_renderer_v2_jax.parallel import distributed
    distributed.initialize("localhost:1234", num_processes=2, process_id=i)
    mesh = distributed.global_mesh(data=2, face=2)   # tile = rest
"""

from __future__ import annotations

import jax

from .mesh import make_mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the multi-process JAX runtime.

    Must run before any other JAX call (anything that initializes the XLA
    backend -- even ``jax.process_count()`` -- makes
    ``jax.distributed.initialize`` fail).  Pass the arguments explicitly
    unless a cluster manager that JAX detects provides them.

    Returns True when the multi-process runtime is up.  With NO arguments
    the call is best-effort (single-process dev sessions return False);
    with explicit arguments a failure is a real misconfiguration and the
    exception propagates -- silently rendering single-host when the user
    asked for a cluster would produce wrong results with no signal.
    """
    explicit = coordinator_address is not None
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except RuntimeError as e:
        if "already" in str(e).lower():
            return True
        if explicit:
            raise
        return False
    except ValueError:
        if explicit:
            raise
        # auto-detection unavailable (single-process session): no-op
        return False


def global_mesh(data=1, tile=None, face=1):
    """A (data, tile[, face]) mesh over EVERY device of every process,
    with the face axis innermost so its ordered z-combine all_gather
    stays within a process's devices where it can."""
    return make_mesh(data=data, tile=tile, face=face, devices=jax.devices())
