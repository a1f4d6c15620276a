"""Client for the persistent sweep server, on the PyTorch port: submit
one accelerator-search query and stream best-so-far results as the
server's shared fleet runs.

Start the port's server in one terminal (on the GPU, or with
``--device cpu`` on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve sweep --port 7333

then submit queries from others (concurrent same-signature queries
coalesce into one mega-batch round on the server — watch
``--stats`` report ~1.0 dispatches/round either way):

    PYTHONPATH=src python examples/sweep_client_torch.py --port 7333 \
        --m 256 --k 256 --n 256 --density 0.3,0.4 --arch cloud \
        --method sparsemap --budget 4000
    PYTHONPATH=src python examples/sweep_client_torch.py --port 7333 --stats

The wire protocol is the JAX package's, so this client also drives
``python -m repro.launch.serve sweep``, and that package's
``examples/sweep_client.py`` drives this server.  The client itself
touches no device.
"""
import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Submit a (workload, arch, density, method, budget) "
                    "query to a running sweep server and stream "
                    "best-so-far updates.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--stats", action="store_true",
                    help="print server stats instead of submitting")
    ap.add_argument("--shutdown", action="store_true",
                    help="ask the server to stop")
    ap.add_argument("--name", default="client_query")
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--density", default="0.3,0.4",
                    help="comma pair: A density, B density")
    ap.add_argument("--arch", default="cloud",
                    help="platform or registered arch name")
    ap.add_argument("--method", default="sparsemap")
    ap.add_argument("--budget", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.search import SearchTask
    from repro_torch.core.workload import spmm
    from repro_torch.launch import sweep_serve

    if args.stats:
        reply = next(iter(sweep_serve.request(
            args.host, args.port, {"op": "stats"})))
        print(json.dumps(reply["stats"], indent=2, default=str))
        return 0
    if args.shutdown:
        print(next(iter(sweep_serve.request(
            args.host, args.port, {"op": "shutdown"}))))
        return 0

    da, db = (float(x) for x in args.density.split(","))
    task = SearchTask(
        spmm(args.name, args.m, args.k, args.n, da, db),
        args.arch, budget=args.budget, seed=args.seed,
        method=args.method)
    for ev in sweep_serve.submit(args.host, args.port, task):
        if not ev.get("ok", True):
            print(f"rejected: {ev['error']}")
            return 1
        if "id" in ev and "event" not in ev:
            print(f"accepted as {ev['id']!r}")
        elif ev.get("event") == "update":
            print(f"  round {ev['round']:>4}  evals {ev['evals']:>6}  "
                  f"best EDP {ev['best_edp']:.4e}")
        elif ev.get("event") == "done":
            print(f"done: best EDP {ev['best_edp']:.4e} after "
                  f"{ev['evals']} evals ({ev['valid_evals']} valid)")
            print(f"best genome: {ev['best_genome']}")
        elif ev.get("event") == "failed":
            print(f"failed: {ev['error']}")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
