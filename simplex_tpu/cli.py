"""Command-line interface — working end-to-end, unlike the reference's.

The reference's ``app.py`` CLI is dead code: it calls ``SolverController()``
without the required wrapper argument and swallows the TypeError
(``/root/reference/app.py:31`` vs ``solver_controller.py:33``; SURVEY.md
§3.5).  This CLI actually solves:

    python -m simplex_tpu.cli interactive          # prompt-driven definition
    python -m simplex_tpu.cli solve problem.json   # solve a saved problem
    python -m simplex_tpu.cli solve afiro.mps      # solve a netlib MPS file
    python -m simplex_tpu.cli solve-latest         # solve last saved problem
    python -m simplex_tpu.cli export-pdf           # PDF of latest solution
    python -m simplex_tpu.cli serve [--port 5000]  # web UI
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

from .config import SolverConfig, enable_compile_cache
from .controllers.cli_io import (
    ConstraintsController,
    ObjectiveFunctionController,
)
from .controllers.orchestrator import solve_problem_dict
from .core.parsing import variable_order
from .core.problem import validate_problem_structure
from .services.storage import StorageService


def _print_report(report: Dict):
    sol = report["solucion_encontrada"]
    print("\n=== Resultado ===")
    print(f"Estado: {sol['status']}")
    print(f"Mensaje: {sol['mensaje_solver']}")
    if sol["status"] == "Solucion Factible":
        for var, val in sol["valores_variables"].items():
            print(f"  {var} = {val:.4f}")
        print(f"  Z = {sol['valor_optimo_z']:.4f}")
    sens = report.get("analisis_sensibilidad")
    if sens:
        print("\n--- Análisis de sensibilidad ---")
        for con, val in sens["precios_sombra"].items():
            print(f"  {con}: precio sombra = {val:.4f}")
        for var, val in sens["costos_reducidos"].items():
            print(f"  {var}: costo reducido = {val:.4f}")


def cmd_interactive(args) -> int:
    storage = StorageService()
    objective = ObjectiveFunctionController(storage).run()
    if not objective:
        return 1
    expected = variable_order(objective["coefficients"].keys())
    constraints = ConstraintsController(storage).run(expected)
    if not constraints:
        return 1
    wrapper = {"problema_definicion": {
        "funcion_objetivo": objective,
        "restricciones": [c.to_dict() for c in constraints],
    }}
    storage.save_problem(wrapper)
    report = solve_problem_dict(wrapper)
    if report is None:
        print("Error durante la resolución.")
        return 1
    _print_report(report)
    return 0


def _solve_wrapper(wrapper: Dict) -> int:
    problem = wrapper.get("problema_definicion")
    if not problem:
        print("El archivo no contiene 'problema_definicion'.")
        return 1
    ok, msg = validate_problem_structure(problem)
    if not ok:
        print(f"Problema inválido: {msg}")
        return 1
    report = solve_problem_dict(wrapper)
    if report is None:
        print("Error durante la resolución.")
        return 1
    _print_report(report)
    return 0


def _solve_mps(args) -> int:
    """Netlib-style MPS solve: full bound vocabulary (FR/MI/negative LO),
    engine selectable — the direct-engine path, since the report schema's
    problem dict cannot express free variables."""
    from .utils.mps import load_mps

    try:
        lp = load_mps(args.file)
    except (IOError, ValueError) as e:
        print(f"No se pudo leer {args.file}: {e}")
        return 1
    engine = getattr(args, "engine", "auto")
    if engine == "auto":
        # Finite variable bounds: the revised engine handles them natively
        # (bounded ratio test — no dense bound rows); otherwise n >> m
        # (netlib-shaped) prefers revised, square/tall prefers dense.
        engine = ("revised" if lp.has_finite_bounds
                  or lp.n_vars >= 2 * lp.n_cons else "dense")
    if engine == "revised":
        from .models.revised import RevisedSimplexSolver
        res = RevisedSimplexSolver(SolverConfig.from_env()).solve(lp)
    elif engine == "host":
        from .models.host import HostSimplexSolver
        res = HostSimplexSolver(SolverConfig.from_env()).solve(lp)
    else:
        from .models.dense import solve_lp
        res = solve_lp(lp, SolverConfig.from_env())

    print(f"\n=== Resultado ({args.file}, motor {engine}) ===")
    print(f"Estado: {res.status} — {res.message}")
    print(f"Iteraciones: {res.nit}   tiempo: {res.solve_time:.3f}s")
    if res.success:
        print(f"Z = {res.z:.10g}")
        head = min(lp.n_vars, 12)
        for v, val in zip(lp.variables[:head], res.x[:head]):
            print(f"  {v} = {val:.6g}")
        if lp.n_vars > head:
            print(f"  ... ({lp.n_vars - head} variables más)")
    return 0 if res.success else 1


def cmd_solve(args) -> int:
    if args.file.lower().endswith((".mps", ".sif")):
        return _solve_mps(args)
    try:
        with open(args.file, "r", encoding="utf-8") as f:
            wrapper = json.load(f)
    except (IOError, json.JSONDecodeError) as e:
        print(f"No se pudo leer {args.file}: {e}")
        return 1
    return _solve_wrapper(wrapper)


def cmd_solve_latest(args) -> int:
    wrapper = StorageService().load_problem()
    if wrapper is None:
        print("No hay problemas guardados.")
        return 1
    return _solve_wrapper(wrapper)


def cmd_export_pdf(args) -> int:
    from .services.pdf import PdfReportService

    storage = StorageService()
    report = storage.load_solution()
    if report is None:
        print("No se encontró una solución para exportar.")
        return 1
    path = storage.new_pdf_path()
    PdfReportService(report, path).generate()
    print(f"Reporte PDF generado: {path}")
    return 0


def cmd_serve(args) -> int:
    from .web.app import init_app
    from .web.microweb import run_dev_server

    run_dev_server(init_app(), host=args.host, port=args.port)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="simplex_tpu",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("interactive", help="definición interactiva + solve")
    p_solve = sub.add_parser("solve", help="resolver un problema JSON o MPS")
    p_solve.add_argument("file")
    p_solve.add_argument("--engine", default="auto",
                         choices=["auto", "dense", "revised", "host"],
                         help="motor para archivos MPS (auto: revised si "
                              "n >= 2m)")
    sub.add_parser("solve-latest", help="resolver el último problema guardado")
    sub.add_parser("export-pdf", help="exportar la última solución a PDF")
    p_serve = sub.add_parser("serve", help="servidor web")
    p_serve.add_argument("--host", default="0.0.0.0")
    p_serve.add_argument("--port", type=int, default=5000)

    args = parser.parse_args(argv)
    enable_compile_cache()
    commands = {
        "interactive": cmd_interactive,
        "solve": cmd_solve,
        "solve-latest": cmd_solve_latest,
        "export-pdf": cmd_export_pdf,
        "serve": cmd_serve,
        None: cmd_interactive,
    }
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
