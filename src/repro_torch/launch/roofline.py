"""Roofline analysis over the dry-run results: the port of
``repro/launch/roofline.py`` with the H100's constants.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

The dry-run (``launch/dryrun.py``) counts every figure per device, so each
term is simply value / peak, already per chip.

Hardware: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates,
without sparsity, at the card's full 700 W): 989 TFLOP/s in bf16, 3.35 TB/s
of HBM3, 80 GB of it.  The link term takes the data sheet's inter-node
figure, one 400 Gb/s NDR InfiniBand port per GPU (50 GB/s): a 16 x 16 mesh
of H100s spans 32 eight-GPU NVLink nodes, and each of its axes crosses
nodes, so a collective along either axis runs at the slowest hop's rate,
not at NVLink's 450 GB/s per direction inside a node.  These are published
figures, not measurements.

    python -m repro_torch.launch.roofline --in results/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import json

PEAK_FLOPS = 989e12      # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12         # HBM3, H100 SXM data sheet
LINK_BW = 50e9           # one 400 Gb/s NDR port per GPU, between nodes
HBM_PER_CHIP = 80e9      # H100 SXM data sheet


def analyse(rec: dict) -> dict:
    if rec["status"] != "OK":
        return dict(rec)
    chips = rec["n_devices"]
    t_compute = rec["hlo_flops_per_device"] / PEAK_FLOPS
    t_memory = rec["hlo_bytes_per_device"] / HBM_BW
    t_coll = rec["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model_fl = rec["model_flops_total"]
    flops_total = rec["hlo_flops_per_device"] * chips
    useful = model_fl / flops_total if flops_total else 0.0
    # roofline fraction: useful-FLOPs time over the bound set by the
    # dominant term (1.0 == the dominant resource is saturated by useful work)
    t_useful = model_fl / (chips * PEAK_FLOPS)
    frac = t_useful / bound if bound else 0.0
    mem = rec.get("memory", {})
    need = mem.get("temp_bytes", 0) + mem.get("argument_bytes", 0)
    out = dict(rec)
    out.update(
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        dominant=dominant, useful_flops_ratio=useful,
        roofline_fraction=frac, fits_hbm=need <= HBM_PER_CHIP,
        hbm_gib=round(need / 2**30, 2),
    )
    return out


def table(records: list[dict], mesh: str = "16x16") -> str:
    rows = []
    hdr = (f"{'arch':<22}{'shape':<13}{'comp(ms)':>9}{'mem(ms)':>9}"
           f"{'coll(ms)':>9} {'dom':<5}{'useful':>7}{'roofl%':>7}"
           f"{'HBM GiB':>9}{'fits':>6}")
    rows.append(hdr)
    rows.append("-" * len(hdr))
    for r in records:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "SKIP":
            rows.append(f"{r['arch']:<22}{r['shape']:<13}"
                        f"{'SKIP: ' + r['reason'][:58]}")
            continue
        if r["status"] != "OK":
            rows.append(f"{r['arch']:<22}{r['shape']:<13}FAIL")
            continue
        a = analyse(r)
        rows.append(
            f"{r['arch']:<22}{r['shape']:<13}"
            f"{a['t_compute_s'] * 1e3:>9.2f}{a['t_memory_s'] * 1e3:>9.2f}"
            f"{a['t_collective_s'] * 1e3:>9.2f} {a['dominant'][:4]:<5}"
            f"{a['useful_flops_ratio']:>7.2f}"
            f"{a['roofline_fraction'] * 100:>7.1f}"
            f"{a['hbm_gib']:>9.2f}{'y' if a['fits_hbm'] else 'N':>6}")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        records = json.load(f)
    print(table(records, args.mesh))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([analyse(r) for r in records], f, indent=1)


if __name__ == "__main__":
    main()
