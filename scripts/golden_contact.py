"""Turnkey golden first contact with a real rrtmgp-data checkout.

The golden-flux matrix (tests/test_real_data.py — the reference's headline
correctness gate, /root/reference/test/runtests.jl:21-23,38-40,54-56) has
never executed against the actual Fortran numbers in this zero-egress build
environment. First contact will happen elsewhere, possibly without the
builder — and a wrong/partial/mis-versioned checkout must fail LOUDLY as a
checkout problem, never masquerade as a physics failure. This script makes
that turnkey:

    RRTMGP_DATA=/path/to/rrtmgp-data python scripts/golden_contact.py

Steps (each gate reported, later gates skipped on hard failure):
  1. CHECKOUT IDENTITY — computes the git tree sha1 of $RRTMGP_DATA exactly
     as git would (blob/tree object hashing, .git excluded) and compares it
     to the v1.9 pin the reference ships: git-tree-sha1
     d601aa60f46f03d12db9841833c7b25bd4dcd785 (/root/reference/
     Artifacts.toml:3-8; release tarball sha256
     e0f868c32efbbe6c0a5bd9b764718f74d9f53b476f65a0d806988bbc83dd13c1).
     An exact match proves byte-identity with the pinned release — any
     mismatch aborts (override with --allow-unpinned to proceed anyway,
     e.g. for a partial checkout or a newer data release).
  2. STRUCTURE — data.manifest.validate_rrtmgp_data: required variables,
     dimension names, internal size relations, v1.9 dimension pins for all
     six lookup files + presence of the input/reference flux files.
  3. GOLDEN MATRIX — runs the 18-test matrix via pytest in BOTH eta node
     semantics (reference first — the mode the Fortran goldens require;
     see tests/test_real_data.py docstring), captures the per-case L-inf
     errors, and emits a parity report table. The reference mode decides
     the exit code; the continuous mode is reported for information (it
     measures the golden deviation of the deliberate continuity fix).

Exit status: 0 iff identity (unless --allow-unpinned) + structure + the
reference-mode matrix all pass.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# /root/reference/Artifacts.toml:3-8 (rrtmgp-data v1.9)
PIN_TREE_SHA1 = "d601aa60f46f03d12db9841833c7b25bd4dcd785"
PIN_TARBALL_SHA256 = (
    "e0f868c32efbbe6c0a5bd9b764718f74d9f53b476f65a0d806988bbc83dd13c1"
)


def git_tree_sha1(root: str) -> str:
    """Git tree sha1 of a directory, computed the way git does (no git
    binary needed): blob = sha1("blob <n>\\0" + bytes); tree entries are
    "<mode> <name>\\0" + 20-byte sha1, sorted by name with directories
    compared as name+"/"; empty directories are untracked. A checkout (git
    clone at the tag, or an extracted release tarball) of rrtmgp-data v1.9
    reproduces the pinned tree hash exactly."""

    def hash_blob(path: str) -> bytes:
        with open(path, "rb") as f:
            data = f.read()
        h = hashlib.sha1()
        h.update(b"blob %d\0" % len(data))
        h.update(data)
        return h.digest()

    def hash_link(path: str) -> bytes:
        data = os.readlink(path).encode()
        h = hashlib.sha1()
        h.update(b"blob %d\0" % len(data))
        h.update(data)
        return h.digest()

    def hash_tree(d: str) -> bytes | None:
        entries = []
        for name in os.listdir(d):
            if name == ".git":
                continue
            p = os.path.join(d, name)
            if os.path.islink(p):
                entries.append((name, b"120000", hash_link(p), False))
            elif os.path.isdir(p):
                sub = hash_tree(p)
                if sub is not None:  # git does not track empty dirs
                    entries.append((name, b"40000", sub, True))
            elif os.path.isfile(p):
                mode = b"100755" if os.access(p, os.X_OK) else b"100644"
                entries.append((name, mode, hash_blob(p), False))
        if not entries:
            return None
        # git sorts tree entries by name, directories as if suffixed "/"
        entries.sort(key=lambda e: e[0] + ("/" if e[3] else ""))
        body = b"".join(
            mode + b" " + name.encode() + b"\0" + sha
            for name, mode, sha, _ in entries
        )
        h = hashlib.sha1()
        h.update(b"tree %d\0" % len(body))
        h.update(body)
        return h.digest()

    digest = hash_tree(root)
    return digest.hex() if digest else "<empty>"


def check_identity(data_dir: str) -> bool:
    print("== 1. checkout identity (git tree sha1 vs the reference's pin) ==")
    got = git_tree_sha1(data_dir)
    ok = got == PIN_TREE_SHA1
    print(f"   computed: {got}")
    print(f"   pinned:   {PIN_TREE_SHA1}  (rrtmgp-data v1.9, "
          f"/root/reference/Artifacts.toml:4)")
    if ok:
        print("   MATCH — byte-identical to the pinned v1.9 release tree")
    else:
        print("   MISMATCH — this is NOT a pristine rrtmgp-data v1.9 tree.")
        print("   (expected: git clone --branch v1.9 "
              "https://github.com/earth-system-radiation/rrtmgp-data,")
        print(f"    or the v1.9 release tarball, sha256 {PIN_TARBALL_SHA256})")
        print("   A golden failure against an unpinned checkout is a CHECKOUT "
              "problem until proven otherwise.")
    return ok


def check_structure(data_dir: str, strict_v19: bool = True) -> bool:
    print("\n== 2. structure validation (data/manifest.py) ==")
    sys.path.insert(0, REPO)
    from rrtmgp_tpu.data import artifact_paths as ap
    from rrtmgp_tpu.data.manifest import ManifestError, validate_rrtmgp_data

    try:
        issues = validate_rrtmgp_data(data_dir, strict_v19=strict_v19)
    except ManifestError as e:
        print(f"   FAIL {e}")
        return False
    bad = {f: msgs for f, msgs in issues.items() if msgs}
    for fname in sorted(issues):
        msgs = issues[fname]
        print(f"   {'FAIL' if msgs else 'ok  '} {fname}")
        for m in msgs:
            print(f"        - {m}")
    # input + reference flux files must exist too
    missing = []
    os.environ["RRTMGP_DATA"] = data_dir
    for kind in ("clearsky", "allsky"):
        for bs in ("lw", "sw"):
            p = ap.get_input_filename(kind, bs)
            if not os.path.exists(p):
                missing.append(p)
    for args in (("gas", "lw", "flux_up"), ("gas", "lw", "flux_dn"),
                 ("gas", "sw", "flux_up"), ("gas", "sw", "flux_dn"),
                 ("gas_clouds", "lw", None), ("gas_clouds", "sw", None),
                 ("gas_clouds_aerosols", "lw", None),
                 ("gas_clouds_aerosols", "sw", None)):
        p = ap.get_reference_filename(*args)
        if not os.path.exists(p):
            missing.append(p)
    for p in missing:
        print(f"   FAIL missing input/reference file: {p}")
    ok = not bad and not missing
    print(f"   structure: {'OK' if ok else 'FAILED'}")
    return ok


_LINF_RE = re.compile(
    r"^(?P<case>[\w()=,\- ]+?)\s+L-inf:\s+up\s+(?P<up>[\d.e+-]+),\s+dn\s+"
    r"(?P<dn>[\d.e+-]+)(?:\s+W/m\^2)?\s+\(tol\s+(?P<tol>[\d.e+-]+)\)",
    re.M,
)


def run_matrix(data_dir: str, eta_mode: str) -> tuple[bool, list[dict], str]:
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["RRTMGP_DATA"] = data_dir
    env["RRTMGP_ETA_NODE_MODE"] = eta_mode
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_real_data.py", "-q"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3600,
    )
    rows = [m.groupdict() for m in _LINF_RE.finditer(r.stdout)]
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    return r.returncode == 0, rows, summary


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_dir", nargs="?",
                   default=os.environ.get("RRTMGP_DATA"),
                   help="rrtmgp-data checkout (default: $RRTMGP_DATA)")
    p.add_argument("--allow-unpinned", action="store_true",
                   help="run the matrix even when the tree hash mismatches")
    p.add_argument("--skip-identity", action="store_true",
                   help="skip the tree-hash computation entirely")
    p.add_argument("--lenient", action="store_true",
                   help="skip the strict v1.9 dimension pins (structure-only "
                        "validation; for newer data releases or rehearsals)")
    p.add_argument("--modes", default="reference,continuous",
                   help="comma-separated eta node modes to run "
                        "(default: reference,continuous; 'reference' decides "
                        "the exit code)")
    args = p.parse_args()
    if not args.data_dir:
        print("usage: RRTMGP_DATA=/path/to/rrtmgp-data "
              "python scripts/golden_contact.py", file=sys.stderr)
        return 2
    data_dir = os.path.abspath(args.data_dir)
    if not os.path.isdir(data_dir):
        print(f"not a directory: {data_dir}", file=sys.stderr)
        return 2
    print(f"rrtmgp_tpu golden first contact\ndata: {data_dir}\n")

    identity_ok = True
    if args.skip_identity:
        print("== 1. checkout identity: SKIPPED (--skip-identity) ==")
    else:
        identity_ok = check_identity(data_dir)
        if not identity_ok and not args.allow_unpinned:
            print("\nABORT: wrong checkout (use --allow-unpinned to force).")
            return 3

    if not check_structure(data_dir, strict_v19=not args.lenient):
        print("\nABORT: structure validation failed — the loaders would "
              "misread these files.")
        return 4

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    print(f"\n== 3. golden matrix (18 tests x eta modes {modes}) ==")
    results = {}
    for mode in modes:
        ok, rows, summary = run_matrix(data_dir, mode)
        results[mode] = (ok, rows)
        print(f"   eta_node_mode={mode}: {summary or ('PASS' if ok else 'FAIL')}")

    print("\n## Parity report (L-inf W/m^2 vs Fortran reference fluxes)\n")
    print("| case | tol | reference-mode up/dn | continuous-mode up/dn |")
    print("|---|---|---|---|")
    ref_rows = {r["case"].strip(): r for r in results.get("reference", (False, []))[1]}
    cont_rows = {r["case"].strip(): r for r in results.get("continuous", (False, []))[1]}
    for case in ref_rows:
        rr = ref_rows[case]
        cc = cont_rows.get(case)
        ccs = f"{cc['up']} / {cc['dn']}" if cc else "—"
        print(f"| {case} | {rr['tol']} | {rr['up']} / {rr['dn']} | {ccs} |")

    ref_ok = results.get("reference", (False, []))[0]
    verdict = (
        "GOLDEN PARITY ACHIEVED"
        if ref_ok and identity_ok
        else ("matrix green but checkout UNPINNED — re-verify with a pristine "
              "v1.9 tree" if ref_ok else "GOLDEN PARITY FAILED (reference mode)")
    )
    print(f"\n{verdict}")
    return 0 if ref_ok else 5


if __name__ == "__main__":
    sys.exit(main())
