"""Multi-chip sharding dry-run, isolated in a subprocess so the 8 virtual
CPU devices don't share this process's single-device XLA runtime (8 async
devices on a 2-core host can starve the pool mid-suite)."""

import os
import subprocess
import sys

import chip_smoke


def test_dryrun_multichip_subprocess():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('MULTICHIP_OK')"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MULTICHIP_OK" in r.stdout


def _run_tool_subprocess(tool, args, cwd, n_devices, mesh):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n_devices}").strip()
    env["NGSBITS_MESH"] = "1" if mesh else "0"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    r = subprocess.run([sys.executable, "-m", "ngsbits_tpu", tool] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


def test_readqc_qcml_identical_1_vs_8_devices(tmp_path):
    """The COMPLETE ReadQC qcML must be identical on one device and on an
    8-virtual-device mesh (NGSBITS_MESH=1 routes the reduction through
    sharded_readqc_step's psum merges)."""
    fq = tmp_path / "r1.fastq.gz"
    chip_smoke.synth_pairs(fq, tmp_path / "r2.fastq.gz", 5000, 1, 300, 60)
    fq = str(fq)
    d1 = tmp_path / "one"; d1.mkdir()
    d8 = tmp_path / "mesh"; d8.mkdir()
    _run_tool_subprocess("ReadQC", ["-in1", fq, "-out", "out.qcML"], d1, 1, False)
    _run_tool_subprocess("ReadQC", ["-in1", fq, "-out", "out.qcML"], d8, 8, True)

    def strip(p):
        return [l for l in p.read_text().splitlines() if "creation " not in l]

    assert strip(d1 / "out.qcML") == strip(d8 / "out.qcML")


def test_bedcoverage_identical_1_vs_8_devices(tmp_path):
    """A complete BedCoverage BED must be byte-identical on 1 vs 8 virtual
    devices (mesh mode defers the diff-array accumulation to
    sharded_coverage_step's scatter-add + psum + scan)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import synth_bam
    bam = tmp_path / "cov.bam"
    synth_bam(str(bam), n_reads=20_000)
    roi = tmp_path / "roi.bed"
    roi.write_text("".join(f"chr1\t{s}\t{s + 50_000}\n"
                           for s in range(1_000_000, 41_000_000, 2_000_000)))
    d1 = tmp_path / "one"; d1.mkdir()
    d8 = tmp_path / "mesh"; d8.mkdir()
    args = ["-in", str(roi), "-bam", str(bam), "-out", "out.bed"]
    _run_tool_subprocess("BedCoverage", args, d1, 1, False)
    _run_tool_subprocess("BedCoverage", args, d8, 8, True)
    assert (d1 / "out.bed").read_bytes() == (d8 / "out.bed").read_bytes()


def test_mappingqc_qcml_identical_1_vs_8_devices(tmp_path):
    """Full MappingQC qcML (ROI mode) must match between one device and an
    8-virtual-device mesh (NGSBITS_MESH=1 routes the ROI depth through
    sharded_coverage_step's scatter-add + psum)."""
    bam, bed = tmp_path / "panel.bam", tmp_path / "panel.bed"
    stub = tmp_path / "genome.fa"
    stub.write_bytes(b"")
    chip_smoke.synth_panel(bam, bed, tmp_path / "genome.fa.fai", 5000, 2,
                           n_regions=300)
    d1 = tmp_path / "one"; d1.mkdir()
    d8 = tmp_path / "mesh"; d8.mkdir()
    args = ["-in", str(bam), "-roi", str(bed), "-no_cont",
            "-ref", str(stub), "-out", "out.qcML"]
    _run_tool_subprocess("MappingQC", args, d1, 1, False)
    _run_tool_subprocess("MappingQC", args, d8, 8, True)

    def strip(p):
        return [l for l in p.read_text().splitlines() if "creation " not in l]

    assert strip(d1 / "out.qcML") == strip(d8 / "out.qcML")


def test_seqpurge_trim_identical_1_vs_8_devices(tmp_path):
    """SeqPurge trimmed outputs must be byte-identical between one device
    and an 8-virtual-device mesh (NGSBITS_MESH=1 shards the insert scan
    over read pairs via sharded_insert_scan)."""
    in1, in2 = tmp_path / "s1.fastq.gz", tmp_path / "s2.fastq.gz"
    chip_smoke.synth_pairs(in1, in2, 3000, 3, 150, 50)
    d1 = tmp_path / "one"; d1.mkdir()
    d8 = tmp_path / "mesh"; d8.mkdir()
    args = ["-in1", str(in1), "-in2", str(in2),
            "-out1", "o1.fastq.gz", "-out2", "o2.fastq.gz",
            "-ncut", "0", "-qcut", "0", "-min_len", "15"]
    _run_tool_subprocess("SeqPurge", args, d1, 1, False)
    _run_tool_subprocess("SeqPurge", args, d8, 8, True)
    import gzip
    for name in ("o1.fastq.gz", "o2.fastq.gz"):
        a = gzip.decompress((d1 / name).read_bytes())
        b = gzip.decompress((d8 / name).read_bytes())
        assert a == b, f"{name} differs between 1 and 8 devices"


def test_two_process_distributed_init():
    """distributed_init (parallel/mesh.py) with 2 real CPU processes: both
    must see process_count()==2 and a global device view."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from ngsbits_tpu.parallel.mesh import distributed_init\n"
        "import jax\n"
        "import jax.numpy as jnp\n"
        "import numpy as np\n"
        f"distributed_init('127.0.0.1:{port}', 2, int(sys.argv[1]))\n"
        "assert jax.process_count() == 2, jax.process_count()\n"
        "assert len(jax.devices()) == 2\n"
        # real cross-process collective: each process contributes its own
        # shard of a ReadQC-style counter; the psum total must be identical
        # everywhere (the multi-host histogram-merge pattern)\n"
        "from jax.sharding import Mesh, PartitionSpec as P\n"
        "mesh = Mesh(np.array(jax.devices()), ('batch',))\n"
        "pid = int(sys.argv[1])\n"
        "local = jnp.full((1, 8), pid + 1, dtype=jnp.int32)\n"
        "arr = jax.make_array_from_process_local_data(\n"
        "    jax.NamedSharding(mesh, P('batch', None)), np.asarray(local),\n"
        "    (2, 8))\n"
        "@jax.jit\n"
        "def total(x):\n"
        "    return x.sum(axis=0)\n"
        "out = np.asarray(jax.device_get(total(arr)))\n"
        "assert (out == 3).all(), out\n"
        "print('DIST_OK')\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert "DIST_OK" in out
