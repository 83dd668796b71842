"""Run one chip_smoke.py phase of several checkouts of this repository in
turns on one card, and set their device times side by side.

    python -m laenerf_tpu_torch.perf.phase_turns --phase gather \\
        --out turns.json A B B A

Each of A, B is the root of a checkout (a `git archive` of a commit
unpacked into a directory that .gitignore lists), so "A B B A" runs
parent, change, change, parent. Each turn runs in a process of its own from
its root: it imports that checkout's port and `chip_smoke.py`, and builds
that checkout's kernels (once per checkout; the build is cached under its
root). The phase is `chip_smoke.phase_<name>(card, device)`, which returns
one dict per site with "site" and "device_ms" (and "library_device_ms"
where the site has a library call), as `phase_gather` does. Turns on one
card in one command keep the card, its power limit and its neighbours the
same for every version compared.
"""

import argparse
import json
import subprocess
import sys

from laenerf_tpu_torch.perf import device_line

TURN = """
import json, sys, torch, chip_smoke
card = chip_smoke.card_line()
res = getattr(chip_smoke, "phase_" + sys.argv[1])(card, torch.device("cuda", 0))
print("TURN " + json.dumps(res), flush=True)
"""


def run_turn(root, phase):
    """One turn: the phase's results from the checkout at root; its other
    output lines are echoed, tagged with the root."""
    proc = subprocess.run([sys.executable, "-c", TURN, phase], cwd=root,
                          capture_output=True, text=True)
    found = None
    for line in proc.stdout.splitlines():
        if line.startswith("TURN "):
            found = json.loads(line[len("TURN "):])
        else:
            print(f"  [{root}] {line}", flush=True)
    if proc.returncode != 0 or found is None:
        raise RuntimeError(f"turn in {root} failed (exit {proc.returncode})"
                           f":\n{proc.stderr[-4000:]}")
    return found


def side_by_side(turns, keys=("device_ms", "library_device_ms")):
    """{site: {key: [the key's value in each turn, None where missing]}}
    over every site of any turn, in first-seen order."""
    sites = dict.fromkeys(r["site"] for turn in turns for r in turn)
    by_turn = [{r["site"]: r for r in turn} for turn in turns]
    return {site: {key: [t.get(site, {}).get(key) for t in by_turn]
                   for key in keys} for site in sites}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="+", help="checkout roots, in turn order")
    p.add_argument("--phase", default="gather",
                   help="chip_smoke.phase_<name> to run (default gather)")
    p.add_argument("--out", help="write turns and table as JSON here")
    args = p.parse_args(argv)
    card = device_line("cuda")
    print(card, flush=True)
    turns = [run_turn(root, args.phase) for root in args.roots]
    table = side_by_side(turns)
    print("device us a call, turn by turn: " + " | ".join(args.roots))

    def us(values):
        return " | ".join("-" if v is None else f"{1e3 * v:.2f}"
                          for v in values)

    for site, row in table.items():
        print(f"{site:20s} kernel {us(row['device_ms'])}; library "
              f"{us(row['library_device_ms'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "phase": args.phase,
                       "roots": args.roots, "turns": turns, "table": table},
                      f, indent=1)
    return table


if __name__ == "__main__":
    main()
