"""What a run loads: nothing of JAX or of the JAX package, compared by
whole top-level names; and a reference that loads nothing of the program."""

import json
import shutil
import subprocess
import sys
import textwrap

from port_bench import harness

ROOT = harness.ROOT

REFUSE = textwrap.dedent("""
    import importlib.abc, sys
    class Refuse(importlib.abc.MetaPathFinder):
        def __init__(self, names): self.names = names
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.names:
                raise ImportError(f"refused: {name}")
            return None
""")


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_dry_run_loads_no_jax():
    code = REFUSE + textwrap.dedent(f"""
        sys.meta_path.insert(0, Refuse({harness.FORBIDDEN!r}))
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / "port_bench" / "tests")!r})
        import time, torch
        from conftest import TINY, SMALL_TRAFFIC
        from port_bench import harness, run
        bench = harness.benchmark()
        for w in bench["workloads"]:
            files = harness.cell_files(bench, w)
            cfg = harness.load_json(files["config"]); cfg["codec"].update(TINY)
            tr = harness.load_json(files["traffic"]); tr.update(SMALL_TRAFFIC[w["traffic"]])
            run.execute(bench, w["name"], 5, 0.1, w["name"] == "roundtrip-f32", torch.device("cpu"),
                        time.perf_counter(), config=cfg, traffic=tr)
        print(json.dumps(harness.forbidden_modules()))
    """)
    out = _python("import json\n" + code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole():
    before = dict(sys.modules)
    try:
        sys.modules["nawc_tpu_torch_lookalike"] = sys
        assert "nawc_tpu_torch_lookalike" not in harness.forbidden_modules()
        sys.modules["nawc_tpu.utils"] = sys
        assert "nawc_tpu.utils" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_reference_loads_nothing_of_the_program():
    code = REFUSE + textwrap.dedent(f"""
        sys.meta_path.insert(0, Refuse(("nawc_tpu_torch",) + {harness.FORBIDDEN!r}))
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        from port_bench.reference import codec, precision, semantic, spread_spectrum, threefry
        cfg = {{"encoder_dim": 4, "encoder_rates": [2, 4, 8, 8], "latent_dim": 16,
               "decoder_dim": 16, "decoder_rates": [8, 8, 4, 2], "vq_strides": [4, 2, 1],
               "sample_rate": 24000}}
        assert codec.chunk(cfg) == 4096
        print("ok", sorted(m for m in sys.modules if m.startswith("port_bench")))
    """)
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_refuses_a_directory_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "roundtrip-f32",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
