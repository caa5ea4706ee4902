"""A module fixture for the port's tests that hold it against the JAX
package on the CPU: import ``light_jax_reference`` into a test module and it
applies to every test there.

Nearly all of those tests' time is XLA compiling the JAX package's programs
(a flip forward of the C=8 fixture HigherHRNet: ~8 s to trace, ~21 s to
compile). With most of XLA's optimizations off
(``jax_disable_most_optimizations``) a compile takes about a third less,
and the programs' outputs move by ~1e-6 of their scale (4e-6 relative on
the fixture net's heatmaps), far inside the tolerances the port is held
to: decisions, 1e-4 of the scale, or exact only where JAX's arithmetic has
no freedom (an argmax). torch runs one intra-op thread, as in the port's
other CPU tests: the suite's workers share a few cores.
"""

from __future__ import annotations

import jax
import pytest
import torch

FLAG = "jax_disable_most_optimizations"


@pytest.fixture(scope="module", autouse=True)
def light_jax_reference():
    """Both settings for the module, restored after it; JAX's caches are
    cleared then, so no later test reuses a program compiled this way."""
    threads, flag = torch.get_num_threads(), jax.config.values[FLAG]
    torch.set_num_threads(1)
    jax.config.update(FLAG, True)
    yield
    jax.config.update(FLAG, flag)
    torch.set_num_threads(threads)
    jax.clear_caches()
