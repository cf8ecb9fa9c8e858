#!/usr/bin/env python
"""SURVEY.md §8 verification checklist, ready to run the moment a
checkout of the upstream reference (`--ref`) is available, so a populated
mount is used at once.

    python tools/verify_reference.py [--ref /root/reference]

Checks, in SURVEY §8 order:
  1. file layout vs the §1/§2 reconstruction (package dir, kernel dir)
  2. SiftPlan symbols in plan.py (real line numbers for citations)
  3. __kernel inventory in *.cl vs the §2.2 table
  4. param.py defaults vs sift_pyocl_jax.config.SiftConfig
  5. matching distance metric (L1 vs L2) in matching*.cl
  6. test-file names vs §4
  7. README/doc benchmark claims for PERF.md

Prints a report and exits 1 if the mount is empty, 0 otherwise.  Every
mismatch is something to patch in SURVEY.md / oracle.py BEFORE perf work.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

EXPECTED_KERNELS = {
    # SURVEY §2.2 reconstruction: file -> kernel symbols we rebuilt against
    "convolution.cl": ["horizontal_convolution", "vertical_convolution"],
    "gaussian.cl": ["gaussian"],
    "preprocess.cl": ["u8_to_float", "rgb_to_float", "shrink", "bin"],
    "reductions.cl": ["max_min_global_stage1", "max_min_global_stage2"],
    "algebra.cl": ["combine"],
    "memset.cl": ["memset"],
    "image.cl": ["local_maxmin", "interp_keypoint", "compact"],
    "orientation_cpu.cl": ["orientation"],
    "orientation_gpu.cl": ["orientation"],
    "keypoints_cpu.cl": ["descriptor"],
    "keypoints_gpu1.cl": ["descriptor"],
    "keypoints_gpu2.cl": ["descriptor"],
    "matching_cpu.cl": ["matching"],
    "matching_gpu.cl": ["matching"],
    "transform.cl": ["transform"],
}

# param.py defaults the JAX config mirrors (SiftConfig field, expected value)
EXPECTED_PARAMS = {
    "DoubleImSize": ("double_im_size", False),
    "InitSigma": ("init_sigma", 1.6),
    "BorderDist": ("border_dist", 5),
    "Scales": ("scales", 3),
    "PeakThresh": ("peak_thresh", 255.0 * 0.04 / 3.0),
    "EdgeThresh": ("edge_thresh", 0.06),
    "EdgeThresh1": ("edge_thresh1", 0.08),
    "MatchRatio": ("match_ratio", 0.73),
}

EXPECTED_TESTS = [
    "test_all.py", "test_image_functions.py", "test_image_setup.py",
    "test_convol.py", "test_gaussian.py", "test_preproc.py",
    "test_reductions.py", "test_algebra.py", "test_image.py",
    "test_keypoints.py", "test_matching.py", "test_transform.py",
    "test_align.py",
]


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", default="/root/reference")
    args = ap.parse_args()
    ref = Path(args.ref)

    files = sorted(p for p in ref.rglob("*") if p.is_file())
    if not files:
        print(f"{ref} is EMPTY — nothing to verify (same as rounds 1-2).")
        print("Re-run this script first thing whenever the mount appears.")
        return 1

    section("1. layout")
    for p in files[:400]:
        print(p.relative_to(ref))
    pkg_dirs = {p.parent.name for p in files if p.name == "plan.py"}
    print(f"\npackage dir candidates (holding plan.py): {pkg_dirs or 'NONE'}")
    cl_dirs = {p.parent.name for p in files if p.suffix == ".cl"}
    print(f"kernel dir candidates (.cl): {cl_dirs or 'NONE'}")

    section("2. plan.py symbols (cite these line numbers in SURVEY.md)")
    for p in files:
        if p.name == "plan.py":
            for i, line in enumerate(p.read_text(errors="replace").splitlines(), 1):
                if re.search(r"class SiftPlan|def keypoints|def _one_octave|"
                             r"def _calc_memory|def _calc_scales|PIX_PER_KP", line):
                    print(f"{p.relative_to(ref)}:{i}: {line.strip()[:90]}")

    section("3. __kernel inventory vs SURVEY §2.2")
    found = {}
    for p in files:
        if p.suffix == ".cl":
            syms = re.findall(r"__kernel\s+\w+\s+(\w+)", p.read_text(errors="replace"))
            found[p.name] = syms
            print(f"{p.name}: {syms}")
    for fname, expected in EXPECTED_KERNELS.items():
        if fname not in found:
            print(f"  !! expected kernel file missing from mount: {fname}")
        else:
            for sym in expected:
                if not any(sym in s for s in found[fname]):
                    print(f"  !! {fname}: expected symbol ~'{sym}' not found "
                          f"(have {found[fname]}) — PATCH oracle/SURVEY")

    section("4. param.py defaults vs SiftConfig")
    for p in files:
        if p.name == "param.py":
            text = p.read_text(errors="replace")
            print(text[:2000])
            for ref_name, (field, expect) in EXPECTED_PARAMS.items():
                m = re.search(rf"{ref_name}\s*[:=]\s*([^\s,}}]+)", text)
                if not m:
                    print(f"  !! {ref_name}: not found in param.py")
                    continue
                print(f"  {ref_name} = {m.group(1)}  (ours {field}={expect})")

    section("5. matching metric (decides ops/match.py parity mode)")
    for p in files:
        if "matching" in p.name and p.suffix == ".cl":
            text = p.read_text(errors="replace")
            has_abs = bool(re.search(r"abs_diff|abs\s*\(", text))
            has_sq = bool(re.search(r"\*\s*diff|diff\s*\*|mad\(", text))
            print(f"{p.name}: abs() present={has_abs}, square terms={has_sq} "
                  "-> L1 if abs-sum, L2 if squared-sum (read the loop!)")
            m = re.search(r"0\.5329|ratio", text)
            if m:
                print(f"  ratio reference found at char {m.start()}")

    section("6. test files vs SURVEY §4")
    test_files = sorted(p.name for p in files if p.name.startswith("test"))
    print(test_files)
    for t in EXPECTED_TESTS:
        if t not in test_files:
            print(f"  !! expected test file not in mount: {t}")

    section("7. README/doc benchmark claims -> PERF.md")
    for p in files:
        if p.name.lower().startswith("readme") or p.suffix in (".rst", ".md"):
            text = p.read_text(errors="replace")
            for i, line in enumerate(text.splitlines(), 1):
                if re.search(r"\d+\s*(ms|fps|s\b|speed|faster|Mpix)", line, re.I):
                    print(f"{p.name}:{i}: {line.strip()[:100]}")

    print("\nDone.  Patch SURVEY.md §2 citations with real file:line, fix any "
          "!! items in oracle.py numerics, then re-run the test suite.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
