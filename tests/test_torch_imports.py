"""The port stands alone: no ``repro_torch`` module imports ``jax`` or any
module of the JAX package ``repro``.

A fresh interpreter installs an import hook that refuses those names,
then imports every module of the port (the async front-end, the traffic
module, training, rescoring, the encoder-decoder, the sharding rule
table, the rank world and the meshes among them), runs its serve entry
point on the CPU, closed-loop, open-loop and over a dp-2 mesh with
prefill/decode disaggregation, and on the encoder-decoder
seamless-m4t-large-v2 with CAMD and cross-modal rescoring, and its
training launcher for two reduced steps; the §4.1 theory module
(``core.theory``) is among those imported.
"""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.launch import serve
serve.main(["--device", "cpu", "--requests", "2", "--max-new", "4",
            "--impl", "paged_cuda", "--num-layers", "1"])
# the async front-end and the open-loop traffic module
out = serve.main(["--device", "cpu", "--requests", "2", "--max-new", "4",
                  "--impl", "paged_cuda", "--num-layers", "1",
                  "--open-loop", "--arrival-rate", "100"])
assert out["metrics"]["completed"] == 2, out["metrics"]
assert {"repro_torch.serving.frontend",
        "repro_torch.serving.traffic"} <= set(names), names
# mesh serving: two logical data shards, prompt pages on shard 0
out = serve.main(["--device", "cpu", "--requests", "2", "--max-new", "4",
                  "--impl", "paged_cuda", "--num-layers", "1",
                  "--serve-dp", "2", "--prefill-shards", "1"])
assert out["engine"].dp == 2, out["engine"].dp
assert {"repro_torch.distributed.sharding", "repro_torch.distributed.context",
        "repro_torch.launch.mesh"} <= set(names), names
# the encoder-decoder: its encoder takes the requests' evidence
assert "repro_torch.models.encdec" in names, names
out = serve.main(["--device", "cpu", "--requests", "2", "--max-new", "4",
                  "--arch", "seamless-m4t-large-v2", "--impl", "cuda",
                  "--xmodal-rescore", "--num-layers", "1"])
assert all(r.n_candidates > 0 for r in out["results"]), out["results"]
# the training launcher: two reduced steps
from repro_torch.launch import train
hist = train.main(["--device", "cpu", "--reduced", "--steps", "2",
                   "--batch", "2", "--seq", "16"])
assert len(hist) == 2, hist
assert {"repro_torch.training.train_loop", "repro_torch.core.rescore",
        "repro_torch.core.theory", "repro_torch.data.tasks"} <= set(names), \
    names
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def test_port_imports_neither_jax_nor_repro():
    # one OpenMP (so one torch) thread: the test workers share the cores
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.strip().splitlines()[-1].split()[1])
    assert n >= 15, out.stdout
