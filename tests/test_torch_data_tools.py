"""The port's data tools against the JAX package's: `data/tsplib.py` on
inline TSPLIB95 / CVRPLIB text (EUC_2D, CEIL_2D, ATT, MAN_2D, MAX_2D, GEO and
every EXPLICIT matrix format; tours, CVRPLIB solutions) gives the same arrays
and costs exactly, and the env adapters the same instances; `data/generate.py`
rebuilds the committed canonical npz files byte for byte, draws through the
port's envs, and raises for an env not ported yet with its ROADMAP.md item."""

import io
import os

import numpy as np
import pytest
import torch

from rl4co_tpu.data import generate as jgen
from rl4co_tpu.data import tsplib as jtsp
from rl4co_tpu_torch.data import generate as tgen
from rl4co_tpu_torch.data import tsplib as ttsp

from _torch_port import ROOT, t2n

torch.set_num_threads(1)

TSP_TEXT = """\
NAME : pent5
TYPE : TSP
COMMENT : five points
DIMENSION : 5
EDGE_WEIGHT_TYPE : EUC_2D
NODE_COORD_SECTION
1 0 0
2 13.5 0.25
3 10 10.5
4 -2 9
5 4.4 4.6
EOF
"""

GEO_TEXT = """\
NAME: ulysses16
TYPE: TSP
DIMENSION: 16
EDGE_WEIGHT_TYPE: GEO
DISPLAY_DATA_TYPE: COORD_DISPLAY
NODE_COORD_SECTION
 1 38.24 20.42
 2 39.57 26.15
 3 40.56 25.32
 4 36.26 23.12
 5 33.48 10.54
 6 37.56 12.19
 7 38.42 13.11
 8 37.52 20.44
 9 41.23 9.10
 10 41.17 13.05
 11 36.08 -5.21
 12 38.47 15.13
 13 38.15 15.35
 14 37.51 15.17
 15 35.49 14.32
 16 39.36 19.56
EOF
"""

ULYSSES16_OPT = """\
NAME : ulysses16.opt.tour
TYPE : TOUR
DIMENSION : 16
TOUR_SECTION
1 14 13 12 7 6 15 5 11 9 10 16 3 2 4 8
-1
EOF
"""

# a 4-node symmetric matrix in each EXPLICIT format
MATRIX = np.array([[0, 3, 5, 9], [3, 0, 4, 7], [5, 4, 0, 2], [9, 7, 2, 0]])
FORMATS = {
    "FULL_MATRIX": MATRIX.reshape(-1),
    "UPPER_ROW": MATRIX[np.triu_indices(4, 1)],
    "LOWER_ROW": MATRIX[np.tril_indices(4, -1)],
    "UPPER_DIAG_ROW": MATRIX[np.triu_indices(4, 0)],
    "LOWER_DIAG_ROW": MATRIX[np.tril_indices(4, 0)],
    "UPPER_COL": MATRIX[np.tril_indices(4, -1)],
    "LOWER_COL": MATRIX[np.triu_indices(4, 1)],
    "UPPER_DIAG_COL": MATRIX[np.tril_indices(4, 0)],
    "LOWER_DIAG_COL": MATRIX[np.triu_indices(4, 0)],
}


def explicit_text(fmt, values):
    rows = " ".join(str(v) for v in values)
    return (f"NAME : m4\nTYPE : TSP\nDIMENSION : 4\nEDGE_WEIGHT_TYPE : EXPLICIT\n"
            f"EDGE_WEIGHT_FORMAT : {fmt}\nEDGE_WEIGHT_SECTION\n {rows}\nEOF\n")


VRP_TEXT = """\
NAME : toy6
TYPE : CVRP
DIMENSION : 6
EDGE_WEIGHT_TYPE : EUC_2D
CAPACITY : 10
NODE_COORD_SECTION
1 5 5
2 0 0
3 10 0
4 10 10
5 0 10
6 7 3
DEMAND_SECTION
1 0
2 3
3 4
4 5
5 6
6 2
DEPOT_SECTION
 1
 -1
EOF
"""

SOL_TEXT = """\
Route #1: 1 2 5
Route #2: 3 4
Cost 42.5
"""


def same(a, b):
    """Two parsed problems or arrays equal, leaf by leaf."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("metric", ["EUC_2D", "CEIL_2D", "ATT", "MAN_2D", "MAX_2D", "GEO"])
def test_coordinate_metrics_parse_and_cost_as_jax(metric):
    text = TSP_TEXT.replace("EUC_2D", metric)
    got, want = ttsp.read_tsplib(text), jtsp.read_tsplib(text)
    same(got, want)
    same(ttsp.tsplib_distance_matrix(got), jtsp.tsplib_distance_matrix(want))
    tour = np.array([0, 4, 1, 2, 3])
    assert ttsp.tour_cost(got, tour) == jtsp.tour_cost(want, tour)
    assert ttsp.tour_cost(got, tour, rounded=False) == jtsp.tour_cost(want, tour, rounded=False)


def test_geo_ulysses16_and_its_tour_file():
    problem, tour = ttsp.read_tsplib(GEO_TEXT), ttsp.read_tsplib_tour(ULYSSES16_OPT)
    same(problem, jtsp.read_tsplib(GEO_TEXT))
    same(tour, jtsp.read_tsplib_tour(ULYSSES16_OPT))
    assert ttsp.tour_cost(problem, tour) == jtsp.tour_cost(problem, tour) == 6859.0


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_explicit_formats_expand_as_jax(fmt):
    text = explicit_text(fmt, FORMATS[fmt])
    got, want = ttsp.read_tsplib(text), jtsp.read_tsplib(text)
    same(got, want)
    np.testing.assert_array_equal(ttsp.tsplib_distance_matrix(got), MATRIX)
    tour = np.array([0, 2, 3, 1])
    assert ttsp.tour_cost(got, tour) == jtsp.tour_cost(want, tour) == 5 + 2 + 7 + 3
    with pytest.raises(ValueError, match="rounded=True"):
        ttsp.tour_cost(got, tour, rounded=False)
    with pytest.raises(ValueError, match="ATSP"):
        ttsp.tsplib_to_tsp_batch(got, device="cpu")


def test_files_on_disk_parse_as_text(tmp_path):
    path = tmp_path / "pent5.tsp"
    path.write_text(TSP_TEXT)
    same(ttsp.read_tsplib(str(path)), jtsp.read_tsplib(TSP_TEXT))
    with pytest.raises(ValueError, match="Unsupported EDGE_WEIGHT_FORMAT"):
        ttsp.read_tsplib(explicit_text("TRIANGLE", FORMATS["UPPER_ROW"]))


def test_cvrplib_problem_solution_and_adapter_match_jax():
    got, want = ttsp.read_tsplib(VRP_TEXT), jtsp.read_tsplib(VRP_TEXT)
    same(got, want)
    same(ttsp.read_cvrplib_solution(SOL_TEXT), jtsp.read_cvrplib_solution(SOL_TEXT))
    for normalize in (True, False):
        tenv, tbatch = ttsp.vrplib_to_cvrp_batch(got, normalize=normalize, device="cpu")
        jenv, jbatch = jtsp.vrplib_to_cvrp_batch(want, normalize=normalize)
        assert (tenv.num_loc, tenv.capacity) == (jenv.num_loc, jenv.capacity)
        for k in jbatch:
            np.testing.assert_array_equal(t2n(tbatch[k]), np.asarray(jbatch[k]))
            assert tbatch[k].dtype == torch.float32
        # the env takes the batch: every customer within one vehicle
        state = tenv.reset(tbatch)
        assert t2n(tenv.action_mask(state))[0, 1:].all()


def test_tsp_adapter_matches_jax():
    problem = ttsp.read_tsplib(TSP_TEXT)
    np.testing.assert_array_equal(ttsp.normalize_coords(problem["node_coords"]),
                                  jtsp.normalize_coords(problem["node_coords"]))
    flat = np.array([[1.0, 2.0], [3.0, 2.0]])  # a zero span stays finite
    np.testing.assert_array_equal(ttsp.normalize_coords(flat), jtsp.normalize_coords(flat))
    for normalize in (True, False):
        tenv, tbatch = ttsp.tsplib_to_tsp_batch(problem, normalize=normalize, device="cpu")
        jenv, jbatch = jtsp.tsplib_to_tsp_batch(problem, normalize=normalize)
        assert tenv.num_loc == jenv.num_loc == 5
        np.testing.assert_array_equal(t2n(tbatch["locs"]), np.asarray(jbatch["locs"]))


def npz_bytes(data):
    buf = io.BytesIO()
    np.savez(buf, **data)
    return buf.getvalue()


@pytest.mark.parametrize("problem,path", [("tsp", "data/tsp/test20_seed1234.npz"),
                                          ("cvrp", "data/cvrp/val50_seed4321.npz")])
def test_reference_convention_rebuilds_the_committed_file(problem, path, tmp_path):
    name = os.path.basename(path)
    n = int(name.split("_")[0].lstrip("testval"))
    seed = int(name.split("seed")[1].split(".")[0])
    with open(os.path.join(ROOT, path), "rb") as f:
        committed = f.read()
    data = tgen.generate_reference_convention(problem, n, 10_000, seed)
    assert npz_bytes(data) == committed
    # and through the command line, as a user would
    tgen.main(["--problem", problem, "--num-loc", str(n), "--seed", str(seed),
               "--convention", "reference", "--data-dir", str(tmp_path), "--name", name])
    with open(tmp_path / problem / name, "rb") as f:
        assert f.read() == committed
    same(data, jgen.generate_reference_convention(problem, n, 10_000, seed))


def test_native_generation_draws_through_the_port(tmp_path):
    data = tgen.generate_dataset("cvrp", 12, 16, 4321, device="cpu")
    again = tgen.generate_dataset("cvrp", 12, 16, 4321, device="cpu")
    other = tgen.generate_dataset("cvrp", 12, 16, 1234, device="cpu")
    assert set(data) == {"locs", "depot", "demand"} and data["locs"].shape == (16, 12, 2)
    same(data, again)
    assert not np.array_equal(data["locs"], other["locs"])
    written = tgen.generate_default_datasets(str(tmp_path), problems=("tsp", "op"), sizes=(8,),
                                             dataset_size=4, device="cpu")
    assert len(written) == 4 and all(os.path.exists(p) for p in written)
    assert tgen.generate_default_datasets(str(tmp_path), problems=("tsp",), sizes=(8,),
                                          dataset_size=4, device="cpu") == []
    tgen.main(["--problem", "mpdp", "--num-loc", "6", "--dataset-size", "3",
               "--data-dir", str(tmp_path), "--device", "cpu"])
    with np.load(tmp_path / "mpdp" / "mpdp6_seed1234.npz") as f:
        assert f["locs"].shape == (3, 6, 2) and f["depot"].shape == (3, 2)


@pytest.mark.parametrize("problem", ["atsp", "ffsp"])
def test_atsp_and_ffsp_datasets_generate(problem, tmp_path):
    data = tgen.generate_dataset(problem, 10, 2, 0, device="cpu")
    if problem == "atsp":
        assert data["cost_matrix"].shape == (2, 10, 10)
    else:   # FFSP takes no num_loc: its defaults, 4 jobs on 2 x 3 machines
        assert data["run_time"].shape == (2, 4, 6)
    written = tgen.generate_default_datasets(str(tmp_path), problems=(problem,), sizes=(10,),
                                             dataset_size=2, device="cpu")
    assert len(written) == 2 and all(os.path.exists(p) for p in written)
    # the reference's numpy stream is not mirrored for either, as in the JAX package
    with pytest.raises(NotImplementedError, match="not mirrored"):
        tgen.generate_reference_convention(problem, 10, 2, 0)
