"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import subprocess
import sys

from isacbench import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "isac_tpu")


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300,
                         check=True)
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    readers = "; ".join(f"harness.load_reader({m['name']!r})" for m in harness.load_spec()["per_layer"])
    mods = _top_level_after(
        "import isacbench.run, isacbench.control, isacbench.capture\n"
        "from isacbench import harness\n"
        "import isacbench.kinds.drops, isacbench.kinds.steady\n"
        "import isac_tpu_torch.api, isac_tpu_torch.sim.network, isac_tpu_torch.sim.cell\n"
        + readers)
    assert "isac_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_after("import isacbench.reference.check, isacbench.reference.channel, "
                            "isacbench.reference.ldpc, isacbench.reference.rdm")
    assert not mods & set(FORBIDDEN + ("isac_tpu_torch",))
