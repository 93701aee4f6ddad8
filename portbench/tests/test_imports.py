"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names, and the plain reference imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

from portbench import run as R

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_forbidden_names_are_whole_top_level_names():
    names = ["dissc_tpu_torch", "dissc_tpu_torch.models.hifigan", "portbench.run", "numpy",
             "jaxtyping", "flaxen", "dissc_tpu", "dissc_tpu.models", "jax", "jax.numpy",
             "jaxlib.xla_client", "flax.linen", "optax"]
    assert R.forbidden_modules(names) == sorted(
        ["dissc_tpu", "dissc_tpu.models", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "optax"])


def _loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r)\n%s\n"
         "print('\\n'.join(sorted(sys.modules)))" % (ROOT, code)],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return out.stdout.split()


def test_every_harness_file_loads_without_jax():
    """Every module, driver and reader of the benchmark, loaded in a fresh
    process, with the port: no JAX, no JAX package."""
    code = ["from portbench import run as R, control, convert, flops, k1_bound, readers, spans, "
            "trace, traffic, weights"]
    for kind in ("drivers", "metrics", "end_to_end"):
        for path in sorted(glob.glob(os.path.join(HERE, kind, "*.py"))):
            code.append(f"R.load_module({kind!r}, {os.path.basename(path)[:-3]!r})")
    loaded = _loaded_after("\n".join(code))
    assert "dissc_tpu_torch" in loaded
    assert R.forbidden_modules(loaded) == []


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in {"__future__", "math", "typing", "contextlib",
                                           "functools", "itertools", "numpy", "torch",
                                           "scipy", "portbench"}, (path, m)
                if m.startswith("portbench"):
                    assert m.startswith("portbench.reference"), (path, m)
    loaded = _loaded_after("import portbench.reference.vocoder, portbench.reference.prosody, "
                           "portbench.reference.hubert, portbench.reference.yaapt")
    assert not [m for m in loaded if m.split(".")[0] in ("dissc_tpu_torch", "dissc_tpu")]
