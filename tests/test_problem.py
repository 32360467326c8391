"""Tests for the LinearProgram IR, standard-form compiler and upload
validation (reference contract: ``ui_controller.validate_problem_structure``
and ``solver_controller._prepare_model_for_scipy``)."""
import numpy as np
import pytest

from simplex_tpu.core.problem import (
    OP_EQ, OP_GE, OP_LE,
    LinearProgram,
    compile_standard_form,
    validate_problem_structure,
)

PROBLEM = {
    "funcion_objetivo": {
        "type": "maximize",
        "coefficients": {"x1": 15.0, "x2": 18.0},
    },
    "restricciones": [
        {"coefficients": {"x1": 4.0, "x2": 2.0}, "operator": "<=", "rhs": 2000.0},
        {"coefficients": {"x1": 2.0, "x2": 6.0}, "operator": ">=", "rhs": 240.0},
        {"coefficients": {"x1": 1.0, "x2": 1.0}, "operator": "=", "rhs": 500.0},
    ],
}


def test_from_problem_dict_round_trip():
    lp = LinearProgram.from_problem_dict(PROBLEM)
    assert lp.maximize
    assert lp.variables == ["x1", "x2"]
    np.testing.assert_array_equal(lp.c, [15.0, 18.0])
    np.testing.assert_array_equal(lp.ops, [OP_LE, OP_GE, OP_EQ])
    assert lp.to_problem_dict() == PROBLEM


def test_missing_constraint_coefficients_default_zero():
    p = {
        "funcion_objetivo": {"type": "minimize",
                             "coefficients": {"x1": 1.0, "x2": 2.0}},
        "restricciones": [
            {"coefficients": {"x1": 3.0}, "operator": "<=", "rhs": 4.0},
        ],
    }
    lp = LinearProgram.from_problem_dict(p)
    np.testing.assert_array_equal(lp.A, [[3.0, 0.0]])


def test_standard_form_layout():
    lp = LinearProgram.from_problem_dict(PROBLEM)
    sf = compile_standard_form(lp)
    # 2 decision vars, slack + surplus (2), artificial for >= and = (2).
    assert sf.n_vars == 2
    assert sf.n_cols == 2 + 2 + 2
    assert sf.need_phase1
    # <= row is basic on its slack; >=/= rows basic on artificials.
    assert sf.tableau[0, 2] == 1.0       # slack of row 0
    assert sf.basis[0] == 2
    # phase-2 mask excludes artificial columns
    assert sf.col_mask_p1[: sf.n_cols].all()
    assert sf.col_mask_p2[:4].all() and not sf.col_mask_p2[4:6].any()
    # min-form objective: maximize → negated c
    np.testing.assert_array_equal(sf.obj_row_p2[:2], [-15.0, -18.0])
    # RHS non-negative after row normalization
    assert (sf.tableau[: sf.n_rows, sf.n_pad] >= 0).all()


def test_standard_form_negative_rhs_flips_operator():
    lp = LinearProgram(c=[1.0], A=[[-2.0]], b=[-6.0], ops=[OP_LE],
                       maximize=False)
    sf = compile_standard_form(lp)
    # -2x <= -6 → 2x >= 6 → surplus + artificial → phase 1 needed.
    assert sf.need_phase1
    assert sf.tableau[0, 0] == 2.0
    assert sf.tableau[0, sf.n_pad] == 6.0


def test_padding_is_tile_aligned():
    lp = LinearProgram.from_problem_dict(PROBLEM)
    sf = compile_standard_form(lp, row_pad=8, col_pad=128)
    # The TOTAL tableau (incl. objective row and RHS column) lands on the
    # (row_pad, col_pad) grid.
    assert sf.tableau.shape == (8, 128)
    assert not sf.col_mask_p1[sf.n_cols:].any()


# ---------------------- upload structure validation ---------------------- #
def test_validate_ok():
    ok, msg = validate_problem_structure(PROBLEM)
    assert ok and msg == ""


@pytest.mark.parametrize(
    "mutate,frag",
    [
        (lambda p: p.pop("funcion_objetivo"), "funcion_objetivo"),
        (lambda p: p["funcion_objetivo"].update(type="max"), "tipo"),
        (lambda p: p["funcion_objetivo"].update(coefficients={}), "coeficientes"),
        (lambda p: p["funcion_objetivo"].update(coefficients={"x1": "a"}),
         "numéricos"),
        (lambda p: p.update(restricciones=[]), "restricciones"),
        (lambda p: p["restricciones"][0].update(operator="<"), "operator"),
        (lambda p: p["restricciones"][0].update(rhs="x"), "RHS"),
        (lambda p: p["restricciones"][0].update(coefficients={}), "coeficientes"),
    ],
)
def test_validate_rejects(mutate, frag):
    import copy

    p = copy.deepcopy(PROBLEM)
    mutate(p)
    ok, msg = validate_problem_structure(p)
    assert not ok
    assert frag.lower() in msg.lower()
