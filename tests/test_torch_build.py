"""Building the CUDA kernels from several processes at once: each writes
its source and library under its own name and renames them into place,
so two processes building the same kernel leave one intact ``.cu``/
``.so`` pair.  A stub compiler on ``$CUDA_HOME/bin`` stands in for
``nvcc``: it copies the source into the "library" after a pause, and
logs the path it was given."""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

_STUB = textwrap.dedent("""\
    #!{python}
    import pathlib, sys, time
    args = sys.argv[1:]
    if "--version" in args:
        print("stub nvcc 0.0")
        sys.exit(0)
    out, src = args[args.index("-o") + 1], args[-1]
    with open({log!r}, "a") as f:
        f.write(src + "\\n")
    text = pathlib.Path(src).read_text()
    time.sleep(0.5)
    if pathlib.Path(src).read_text() != text:
        sys.exit("the source changed under the compiler")
    pathlib.Path(out).write_text("built from:" + text)
""")

_CHILD = textwrap.dedent("""\
    import pathlib, sys, time
    from repro_torch.kernels import build
    build.BUILD_DIR = pathlib.Path(sys.argv[1])
    go = pathlib.Path(sys.argv[2])
    job = build.Job("// kernel source\\n" * 2000, (), build.BUILD_DIR,
                    lambda lib: None)
    key = build.digest(job)
    while not go.exists():
        time.sleep(0.01)
    build._finish_compile(key, build._start_build(job, key))
    print(key)
""")


def test_two_processes_building_one_kernel_leave_one_intact_pair(tmp_path):
    stub_home = tmp_path / "cuda"
    (stub_home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = stub_home / "bin" / "nvcc"
    nvcc.write_text(_STUB.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    out_dir, go = tmp_path / "build", tmp_path / "go"
    env = {**os.environ, "CUDA_HOME": str(stub_home),
           "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(out_dir),
                               str(go)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    time.sleep(1.0)  # both children importing and waiting at the gate
    go.write_text("")
    results = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
    keys = {out.strip() for out, _ in results}
    assert len(keys) == 1
    key = keys.pop()
    source = "// kernel source\n" * 2000
    assert sorted(p.name for p in out_dir.iterdir()) == [f"{key}.cu",
                                                         f"{key}.so"]
    assert (out_dir / f"{key}.cu").read_text() == source
    assert (out_dir / f"{key}.so").read_text() == "built from:" + source
    compiled = log.read_text().split()
    # both compiled (they started together), each its own source file
    assert len(compiled) == 2 and len(set(compiled)) == 2
    assert all(pathlib.Path(c).name != f"{key}.cu" for c in compiled)
