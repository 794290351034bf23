"""The MCMC ``Run`` (port of the ``Run`` of ``delphy_tpu/run.py``): the
exponential or skygrid population model, optional site-rate heterogeneity
(``hyp.alpha_move_enabled``) and the mpox hack's two-partition APOBEC model,
on one device or, with a ``PartMesh`` (``parallel/distributed.py``), one
process per device.

Owns the device state and the step/cadence bookkeeping.  Each
``do_mcmc_steps`` call runs dispatches of partitioned boundaries (global
moves + local sweep) on the run's device, and host topology bursts through
the port's native C++ topology kernel (``native/``) or, without it (no g++,
or ``DELPHY_TPU_NATIVE=0``), the Python ``TopologyMixer`` (``topo/``), as
the reference ``Run`` falls back.  The host syncs where the
reference ``Run`` does: draining the attempted-move counts and fetching the
fused state bundle at a burst.  Two drivers, as in the reference: the
blocking one (a dispatch, then a burst), and above 6M local moves per
boundary (about 60k tips) the overlapped one, whose host burst on one half
of the parts runs while the device sweeps the other half
(``DELPHY_TPU_OVERLAP`` = ``auto`` | ``0`` | ``1`` chooses).  The
reference ``Run``'s other overrides are read where it reads them:
``DELPHY_TPU_RESTENCIL`` (boundaries between restencils) when a run is made,
``DELPHY_TPU_MAX_DISPATCH_MOVES`` at each call of either driver,
``DELPHY_TPU_TOPO_PARTS`` (topology parts) and ``DELPHY_TPU_TOPO_SINGLE=1``
(one unpartitioned burst) at each burst, and ``DELPHY_TPU_CPB`` (cells per
colour block) when ``parallel/sweep.py`` is imported.

Under a mesh every rank runs this same host program on the same seeds:
the host RNG, the topology bursts, the repartitions and the moves-per-block
feedback (fed by the all-reduced move counts) are replicated, and only the
sweep's part rows are split between the ranks.  Trajectories are the
single-process run's bit for bit, except that the overlapped driver rounds
its selection width down to a multiple of the ranks, as the JAX mesh run
does, and then follows that run's split; ``check_derived_quantities`` also
checks that the ranks still agree.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device, resolve_dtype
from . import pop as popm
from .convert import part_maps_to_torch
from .evo import EvoParams, apobec_context_partition, make_evo_params
from .mcmc import global_moves as gm
from .mcmc.global_moves import PriorConfig
from .mcmc.kernel import boundary_grid_bounds
from .mcmc.moves import Ledger
from .native import run_burst_native
from .ops import coalescent as coal
from .ops import likelihood as lk
from .parallel.dispatch_graph import DispatchGraphs
from .parallel.partmaps import (auto_num_partitions, build_part_maps,
                                host_mut_nodes, pad_part_maps, part_size_cap)
from .parallel.sweep import NB_MAX, NB_MAX_SKYGRID, parts_multi_super_step
from .phylo import FlatTree, rereference_to_root_sequence
from .state import TreeState, fetch_fused, fetch_later, fetch_one, \
    pack_state, split_for_host, unpack_state
from .topo.mixer import (HostCoalGrid, HostExpPop, HostSkygridPop,
                         TopologyMixer)
from .topo.parallel import run_bursts_on_parts, run_partitioned_bursts
from .topo.partition import partition_tree, reassemble
from .topo.reform import resample_multi_site_chains

# Dispatch cap: at most this many local moves of boundaries per dispatch
# (DELPHY_TPU_MAX_DISPATCH_MOVES overrides it, read at each call, as the
# reference reads it).
MAX_DISPATCH_MOVES = 32_000_000
# The overlapped driver's cap per cycle, larger: its merge is a fixed cost
# per cycle, which more boundaries amortize (the reference's, run.py:440-448;
# the same variable overrides it)
OVERLAP_DISPATCH_MOVES = 96_000_000
# Above this many local moves per boundary (about 60k tips) the overlapped
# driver is the default (the reference's gate, run.py:405-416)
OVERLAP_MIN_MOVES = 6_000_000
# Boundaries between periodic restencils (the reference's stencil refresh,
# run.cpp:87-108); DELPHY_TPU_RESTENCIL overrides it, read when a run is
# made.
RESTENCIL_INTERVAL = 200


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _round_cap(n: int) -> int:
    return (max(n, 64) + 127) // 128 * 128


def _round16(n: int) -> int:
    return (max(n, 16) + 15) // 16 * 16


def mesh_partitions(P: int, D: int) -> int:
    """The device part count of a run asking for P parts on a mesh of D
    ranks: a multiple of D, at least D (delphy_tpu/run.py:238-241)."""
    return max(D, (P + D - 1) // D * D)


def round_parts(p: int, D: int) -> int:
    """A sticky padded part axis for p parts: a multiple of 8, then of the
    mesh's D ranks (the JAX package's ``_round_parts``, run.py:317-323)."""
    q = (p + 7) // 8 * 8
    return (q + D - 1) // D * D


class HostView(NamedTuple):
    """What the I/O layer reads of a run, on the host: ``evo`` and ``pop``
    with numpy leaves, the ledger's terms as numpy floats (None before the
    first dispatch), the node times, the root and the last boundary's
    mutation count."""
    evo: EvoParams
    pop: popm.ExpPopParams | popm.SkygridPopParams
    ledger: Ledger | None
    t: np.ndarray
    root: int
    num_muts: int | None


def calc_ledger(ts: TreeState, evo, pop_params, t_max_tip, num_cells: int,
                hyp: PriorConfig) -> Ledger:
    """From-scratch ledger recompute under the current parameters."""
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    t_lo, t_step = boundary_grid_bounds(ts, t_max_tip, num_cells)
    grid = coal.make_grid(pop_params, ts.t, ts.is_tip, t_lo, t_step,
                          num_cells)
    log_coal = coal.calc_log_prior(grid, pop_params, ts.t, ts.is_tip)
    log_other = gm.calc_log_other_priors(evo, pop_params, hyp)
    return Ledger(log_G=log_G, log_coal=log_coal, log_other=log_other)


class Run:
    def __init__(self, tree: FlatTree, seed: int = 0,
                 hyp: PriorConfig = PriorConfig(), num_cells: int = 512,
                 local_moves_per_global_move: int = -1,
                 topology_moves_enabled: bool = True,
                 topology_partitions: int = 0,
                 topology_parallel_processes: bool = True,
                 device_partitions: int = 0, device=DEFAULT_DEVICE,
                 pop_model: str = "exp", skygrid_num_parameters: int = 50,
                 skygrid_cutoff_days: float | None = None,
                 skygrid_type: int = popm.STAIRCASE,
                 skygrid_x0_days: float | None = None,
                 skygrid_xM_days: float | None = None,
                 skygrid_tau: float | None = None,
                 skygrid_double_half_time_days: float | None = None,
                 skygrid_init_nbar_days: float = 3.0 * 365.0,
                 mpox_hack: bool = False, mesh=None, dtype=None):
        # with a mesh the run lives on the rank's device
        self.mesh = mesh
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not of the mesh's "
                                 f"type ({mesh.device})")
            device = mesh.device
        self.device = resolve_device(device)
        # float32 or float64: ``dtype``, else DELPHY_TPU_F32 (resolve_dtype)
        self.dtype = resolve_dtype(dtype)
        tree.check_integrity()
        tree = tree.copy()  # the Run owns its tree: bursts mutate it
        self.names = list(tree.name)
        n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
        self.mut_capacity = _round_cap(2 * n_muts + 256)
        n_ivs = sum(len(iv) for iv in tree.miss_intervals)
        self.miss_capacity = _round_cap(2 * n_ivs + 128)
        n_fs = sum(len(fs) for fs in tree.miss_from_states)
        self.fs_capacity = _round_cap(4 * n_fs + 128)
        self.ts: TreeState = pack_state(tree, self.mut_capacity,
                                        self.miss_capacity, self.fs_capacity,
                                        device=self.device, dtype=self.dtype)
        # fused (ints, floats) copy of (ts, evo, pop) from the last dispatch;
        # None whenever host code has since replaced any of the three
        self._fused_bundle = None
        self.hyp = hyp
        self.num_cells = num_cells
        self.topology_moves_enabled = topology_moves_enabled
        self.topology_partitions = topology_partitions
        # partitioned Python-mixer bursts in worker processes (False: in
        # this process; the native kernel's threads either way)
        self.topology_parallel_processes = topology_parallel_processes
        self.restencil_interval = _env_int("DELPHY_TPU_RESTENCIL",
                                           RESTENCIL_INTERVAL)
        self._topo_debt = 0
        self.host_rng = np.random.default_rng(np.uint64(seed)
                                              + 0x9E3779B97F4A7C15)
        self.topology_accepted = 0
        self.topology_proposed = 0
        self.dispatch_count = 0
        self.burst_count = 0
        self.last_cycle = None     # the last overlapped cycle's stages
        N = self.ts.num_nodes
        self.local_moves_per_global_move = (
            50 * N if local_moves_per_global_move == -1
            else local_moves_per_global_move)
        lm = max(1, self.local_moves_per_global_move)
        self.topology_burst_chunks = (max(2, min(256, 2_000_000 // lm))
                                      if lm <= 2_000_000 else 32)

        self.mpox_hack = mpox_hack
        if mpox_hack:
            # two-partition APOBEC model (reference set_mpox_hack_enabled,
            # run.cpp:359-398): partitions from the first tip's sequence, JC
            # rates with uniform pi, rho = mu_star / mu starts at 0
            self.hyp = hyp = dataclasses.replace(hyp, mpox_enabled=True)
            self.evo = make_evo_params(
                tree.num_sites, mu=1e-3 / 365.0, kappa=1.0,
                pi=np.full(4, 0.25), alpha=10.0,
                part=apobec_context_partition(tree.sequence_at(0)),
                device=self.device, dtype=self.dtype).with_mpox_rho(rho=0.0)
        else:
            # initial HKY pi from ref-sequence state frequencies
            # (run.cpp:61-80)
            freq = np.bincount(np.asarray(tree.ref_seq),
                               minlength=4).astype(np.float64)
            est_pi = freq / freq.sum()
            if est_pi.min() < 0.01 or est_pi.max() > 0.99:
                est_pi = np.full(4, 0.25)
            self.evo = make_evo_params(tree.num_sites, mu=1e-3 / 365.0,
                                       kappa=1.0, pi=est_pi, alpha=10.0,
                                       device=self.device, dtype=self.dtype)
        t_max_tip = float(np.max(tree.t_max[:tree.num_tips]))
        self.t_max_tip = t_max_tip

        def f(x):
            return torch.tensor(x, dtype=self.dtype, device=self.device)
        if pop_model == "exp":
            # Exp(t0 = max tip time, n0 = 1000, g = 0, min_pop = 1)
            # (run.cpp:21)
            self.pop = popm.ExpPopParams(t0=f(t_max_tip), n0=f(1000.0),
                                         g=f(0.0), min_pop=f(1.0))
        elif pop_model == "skygrid":
            x, gamma, tau0 = self._initial_skygrid(
                tree, t_max_tip, skygrid_num_parameters, skygrid_cutoff_days,
                skygrid_x0_days, skygrid_xM_days, skygrid_tau,
                skygrid_double_half_time_days, skygrid_init_nbar_days)
            self.pop = popm.SkygridPopParams(x=f(x), gamma=f(gamma),
                                             type=int(skygrid_type),
                                             tau=f(tau0))
        else:
            raise ValueError(f"unknown pop_model {pop_model!r}")
        self._set_euler(tree)

        self.device_partitions = (device_partitions if device_partitions > 0
                                  else auto_num_partitions(tree.num_tips))
        if mesh is not None:
            self.device_partitions = mesh_partitions(self.device_partitions,
                                                     mesh.size)
        self._host_tree = tree          # topology/t synced at repartition
        self._n_cap_sticky = 0
        self._m_cap_sticky = 0
        self._P_sticky = 0
        self.pm = None
        self._boundaries_since_repart = 0
        self._repartition()

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        # the dispatches' CUDA graphs, both drivers'
        # (parallel/dispatch_graph.py)
        self._graphs = DispatchGraphs()
        self.step = 0
        self.local_moves_attempted = 0
        self.ledger: Ledger | None = None
        self.last_stats = None

    def _initial_skygrid(self, tree, t_max_tip, num_parameters, cutoff_days,
                         x0_days, xM_days, tau, double_half_time_days,
                         init_nbar_days):
        """(x, gamma, tau) of a new skygrid, with the reference package's
        draws from ``host_rng``.  Knots: explicit first and last dates
        (cmdline.cpp:947-993), else x_k = T - (M - k) / M * K
        (pop_model.h:144-147) with the cutoff K defaulting to 1.2x the
        initial tree's span."""
        M = max(1, num_parameters - 1)
        t_root0 = float(tree.t[tree.root])
        if x0_days is not None and xM_days is not None:
            if x0_days >= xM_days:
                raise ValueError("skygrid first knot must precede last")
            x = x0_days + np.arange(M + 1, dtype=np.float64) / M \
                * (xM_days - x0_days)
        else:
            K = (cutoff_days if cutoff_days
                 else 1.2 * max(t_max_tip - t_root0, 1.0))
            x = t_max_tip - (M - np.arange(M + 1, dtype=np.float64)) / M * K
        if tau is not None:
            tau0 = float(tau)
        elif double_half_time_days is not None:
            # random-walk diffusion D = log^2(2) / (2 T_dh);
            # tau = 1 / (2 D dt) (cmdline.cpp:1026-1045)
            dt_knot = (x[-1] - x[0]) / M
            D = math.log(2.0) ** 2 / (2.0 * double_half_time_days)
            tau0 = 1.0 / (2.0 * D * dt_knot)
        else:
            tau0 = 1.0
        # initial gamma: a random walk at precision tau, recentred on the
        # initial N_bar (cmdline.cpp:1140-1153)
        g = np.concatenate([[0.0], np.cumsum(
            self.host_rng.normal(0.0, np.sqrt(1.0 / tau0), M))])
        g += -g.mean() + np.log(init_nbar_days)
        return x, g, tau0

    def _set_euler(self, tree: FlatTree):
        tin, tout = tree.euler_positions()
        self.tin = torch.as_tensor(np.asarray(tin), device=self.device)
        self.tout = torch.as_tensor(np.asarray(tout), device=self.device)

    # -- attempted-move accounting -----------------------------------------

    def _absorb(self, arr, boundaries: int, n_blocks: int):
        """Count one dispatch's attempted moves (a host sync) and feed the
        measured moves-per-block rate that sizes later dispatches."""
        attempted = int(arr)
        self.local_moves_attempted += attempted
        measured = attempted / (boundaries * n_blocks)
        self._per_block_rate = max(
            1.0, 0.7 * self._per_block_rate + 0.3 * measured)

    def _repartition(self, sync_times: bool = False):
        """(Re)build the device partition maps from the current tree
        (Run::repartition, run.cpp:110-190), with the same host draws and
        sticky capacities as the reference package's ``Run``."""
        tree = self._host_tree
        if sync_times:
            tree.t = self.ts.t.cpu().numpy().astype(np.float64).copy()
        P = self.device_partitions
        pm, self._last_cuts = build_part_maps(
            tree, host_mut_nodes(tree, self.mut_capacity), P, self.host_rng,
            return_cuts=True)
        if self._P_sticky < P:
            self._P_sticky = P
        if pm.num_parts > self._P_sticky:
            self._P_sticky = round_parts(int(1.1 * pm.num_parts),
                                         self.mesh.size if self.mesh else 1)
        P = self._P_sticky
        if self._n_cap_sticky == 0:
            self._n_cap_sticky = _round16(int(1.4 * pm.n_cap) + 16)
            if P > 1:
                # the oversized-part splitter bounds every stencil's worst
                # part at part_size_cap()
                hard = _round16(max(part_size_cap(), pm.n_cap))
                self._n_cap_sticky = min(self._n_cap_sticky, hard)
            self._m_cap_sticky = _round16(2 * pm.m_cap + 16)
        if pm.n_cap > self._n_cap_sticky:
            self._n_cap_sticky = _round16(int(1.5 * pm.n_cap))
        if pm.m_cap > self._m_cap_sticky:
            self._m_cap_sticky = _round16(int(1.5 * pm.m_cap))
        pm = pad_part_maps(pm, P, self._n_cap_sticky, self._m_cap_sticky,
                           tree.num_nodes, self.mut_capacity)
        self.pm = part_maps_to_torch(pm, self.device, self.dtype)
        n_cap = self._n_cap_sticky
        if not hasattr(self, "_per_block_rate") or self._per_block_rate <= 1.0:
            self._per_block_rate = float(self.device_partitions
                                         * (1 + n_cap // 4 + n_cap // 2))

    # -- parameter setters (subset of the reference's Run API) --------------

    def _scalar(self, x) -> torch.Tensor:
        return torch.tensor(float(x), dtype=self.dtype, device=self.device)

    def set_mu(self, mu: float):
        self.evo = self.evo._replace(mu=self._scalar(mu))
        self._fused_bundle = None

    def set_alpha(self, alpha: float):
        self.evo = self.evo._replace(alpha=self._scalar(alpha))
        self._fused_bundle = None

    def set_pop(self, n0=None, g=None, min_pop=None):
        """Exponential model's parameters."""
        given = {k: self._scalar(v) for k, v in
                 (("n0", n0), ("g", g), ("min_pop", min_pop)) if v is not None}
        self.pop = self.pop._replace(**given)
        self._fused_bundle = None

    # -- MCMC ---------------------------------------------------------------

    def _nb_cap(self, overlapped: bool = False) -> int:
        """Blocks per boundary at most, the reference's caps
        (delphy_tpu/run.py:508-527,661-667): NB_MAX on the exponential
        model, twice that for the overlapped driver's half-width sweep,
        NB_MAX_SKYGRID on a skygrid."""
        if isinstance(self.pop, popm.SkygridPopParams):
            return NB_MAX_SKYGRID
        return 2 * NB_MAX if overlapped else NB_MAX

    def do_mcmc_steps(self, n_steps: int):
        """Advance n_steps local moves, interleaving global boundaries at the
        configured cadence (Run::do_mcmc_steps, run.cpp:622-657); topology
        moves run as host bursts at dispatch ends, or overlapped with the
        device's sweep (``_overlap_active``)."""
        if self._overlap_active():
            return self._do_mcmc_steps_overlapped(n_steps)
        done = 0
        cadence = self.local_moves_per_global_move
        K = self.topology_burst_chunks
        P = self.device_partitions
        max_dispatch = _env_int("DELPHY_TPU_MAX_DISPATCH_MOVES",
                                MAX_DISPATCH_MOVES)
        k_cap = max(1, min(K, max_dispatch // max(1, cadence)))
        if P > 1:
            k_cap = min(k_cap, self.restencil_interval)
        while done < n_steps:
            remaining = n_steps - done
            boundaries = max(1, min(k_cap, remaining // cadence))
            chunk = min(remaining, boundaries * cadence)
            per_boundary = (chunk + boundaries - 1) // boundaries
            nb_cap = self._nb_cap()
            n_blocks = max(1, min(nb_cap,
                                  round(per_boundary / self._per_block_rate)))
            (self.ts, self.evo, self.pop, self.ledger, self.last_stats,
             self._fused_bundle) = parts_multi_super_step(
                self.ts, self.evo, self.pop, self.gen, self.tin, self.tout,
                self.pm, n_blocks, self.t_max_tip, self.hyp, self.num_cells,
                boundaries, nb_max=nb_cap, mesh=self.mesh,
                graphs=self._graphs)
            self.dispatch_count += 1
            # every dispatch's count feeds the next dispatch's size, waiting
            # for the card's tail of it: a rule, not a question of whether
            # the card has finished, so repeats of a run and the ranks of a
            # mesh size their dispatches alike
            self._absorb(self.last_stats["local_moves_attempted"],
                         boundaries, n_blocks)
            self._boundaries_since_repart += boundaries
            repartitioned = False
            if self.topology_moves_enabled:
                self._topo_debt += int(self.host_rng.binomial(chunk,
                                                              2.0 / 30.0))
                threshold = max(32, K * int(cadence * 2.0 / 30.0))
                flush = (done + chunk >= n_steps
                         and self._topo_debt
                         >= max(32, int(cadence * 2.0 / 30.0)))
                if self._topo_debt >= threshold or flush:
                    self._topology_burst(self._topo_debt)
                    self.local_moves_attempted += self._topo_debt
                    self._topo_debt = 0
                    repartitioned = True
            if (not repartitioned and P > 1
                    and self._boundaries_since_repart
                    >= self.restencil_interval):
                self._repartition(sync_times=True)
            if (repartitioned
                    or self._boundaries_since_repart
                    >= self.restencil_interval):
                self._boundaries_since_repart = 0
            done += chunk
        self.step += n_steps

    # -- the overlapped driver (delphy_tpu/run.py:393-621) -------------------

    def _overlap_active(self) -> bool:
        """Overlapped cycles: the device sweeps one random half of the parts
        while the host runs the topology burst on the other half, both
        conditioning on the same frozen boundary values (the reference's
        fork-join argument, run.cpp:682-693, with the device and the host as
        the two workers).  ``DELPHY_TPU_OVERLAP``: ``0`` off, ``1`` on,
        ``auto`` (the default) on above OVERLAP_MIN_MOVES local moves per
        boundary, where the reference measured overlap winning (100k tips)
        and not below (a tie at 30k, a loss at 10k).

        It stays on under a mesh.  The JAX package turns it off on a
        multi-process mesh (delphy_tpu/run.py:418-425) because its merge
        repacks host state that would then need its ``replicate_to_mesh``
        step; here every rank runs the same burst and merge into state of
        its own, so no such step exists, and the L-dispatch's selected rows
        are split between the ranks like any other."""
        env = os.environ.get("DELPHY_TPU_OVERLAP", "auto")
        if env == "0":
            return False
        if env == "auto" and \
                self.local_moves_per_global_move <= OVERLAP_MIN_MOVES:
            return False
        return self.topology_moves_enabled and len(self._last_cuts) + 1 >= 4

    def _do_mcmc_steps_overlapped(self, n_steps: int):
        """Overlap cycles: [G: one globals-only boundary] -> enqueue [L:
        locals-only boundaries on the device half A] -> host burst on the
        other half B (while L runs) -> join L, merge -> repartition.  The
        host's draws are the reference's, in its order.  Each cycle's stage
        times (host clock, s) are left in ``last_cycle``.

        On CUDA both dispatches replay CUDA graphs from the run's cache
        (``dispatch_graph.graph_rule``; a staged mesh runs them eagerly):
        G's graph has no sweep, L's takes the selection as an input of its
        static buffers, so a new selection of the same width replays it.
        G's replay, its hand-off and the copy of its parameters
        (``fetch_later``) run in that order on the current stream, and L's
        copy-in of the selection follows them there, before its replays;
        a capture of either waits for that stream and is waited for by
        it."""
        cadence = self.local_moves_per_global_move
        max_dispatch = _env_int("DELPHY_TPU_MAX_DISPATCH_MOVES",
                                OVERLAP_DISPATCH_MOVES)
        done = 0
        while done < n_steps:
            t0 = time.perf_counter()
            remaining = n_steps - done
            boundaries = max(1, min(self.topology_burst_chunks,
                                    self.restencil_interval,
                                    max(1, max_dispatch // max(1, cadence)),
                                    remaining // cadence))
            chunk = min(remaining, boundaries * cadence)
            per_boundary = (chunk + boundaries - 1) // boundaries

            # the host tree must mirror the device state: it does after a
            # cycle's merge; after a blocking dispatch, sync it once
            if self._fused_bundle is not None:
                ints, flts = self._fused_bundle
                ts_h, _evo_h, _pop_h = split_for_host(
                    (self.ts, self.evo, self.pop), ints.cpu(), flts.cpu())
                self._host_tree = unpack_state(ts_h, names=self.names)
                self._fused_bundle = None
                self._repartition()
            tree = self._host_tree

            # A/B split over the real parts of the current stencil; pad
            # rows (n_nodes 0) fill a selection wider than A
            P_sticky = self.pm.node_map.shape[0]
            n_real = len(self._last_cuts) + 1
            W = max(1, P_sticky // 2)
            if self.mesh is not None:
                # the selection shards over the ranks: round its width as
                # the JAX mesh run does (delphy_tpu/run.py:485-487), so the
                # split, and the trajectory, follow that run's
                D = self.mesh.size
                W = max(D, W // D * D)
            perm = self.host_rng.permutation(n_real)
            n_dev = min(W, max(1, n_real - 1))
            A = np.sort(perm[:n_dev])
            B = np.sort(perm[n_dev:])
            sel = np.full(W, n_real, np.int32)
            sel[:n_dev] = A
            assert P_sticky > n_real or n_dev == W, \
                "selection width exceeds real parts with no padding rows"
            # copied before G: a host-to-device copy from pageable memory
            # waits for the stream
            sel_t = torch.as_tensor(sel, device=self.device).long()

            # G: one globals-only boundary (parameter moves and the ledger)
            ts_g, evo_g, pop_g, _ledger_g, _stats_g, _fused_g = \
                parts_multi_super_step(
                    self.ts, self.evo, self.pop, self.gen, self.tin,
                    self.tout, self.pm, 0, self.t_max_tip, self.hyp,
                    self.num_cells, 1, param_moves=True, mesh=self.mesh,
                    graphs=self._graphs)
            g_params = fetch_later((evo_g, pop_g))
            # L: locals-only boundaries on the device half, enqueued before
            # the burst starts; the half-width sweep gets twice the blocks
            nb_cap = self._nb_cap(overlapped=True)
            n_blocks = max(1, min(nb_cap, round(
                per_boundary / max(1.0, self._per_block_rate * n_dev
                                   / max(1, n_real)))))
            ts_l, evo_l, pop_l, ledger_l, stats_l, fused_l = \
                parts_multi_super_step(
                    ts_g, evo_g, pop_g, self.gen, self.tin, self.tout,
                    self.pm, n_blocks, self.t_max_tip, self.hyp,
                    self.num_cells, boundaries, param_moves=False,
                    part_sel=sel_t, nb_max=nb_cap, mesh=self.mesh,
                    graphs=self._graphs)
            self.dispatch_count += 2
            t1 = time.perf_counter()

            # G's parameters (waits for G alone), then the burst on B
            evo_h, pop_h = g_params()
            mu, nu, q, pi = (float(evo_h.mu), np.asarray(evo_h.nu),
                             np.asarray(evo_h.q), np.asarray(evo_h.pi))
            part, q_tab = np.asarray(evo_h.part), np.asarray(evo_h.q_tab)
            if isinstance(pop_h, popm.SkygridPopParams):
                host_pop = HostSkygridPop(np.asarray(pop_h.x),
                                          np.asarray(pop_h.gamma), pop_h.type)
            else:
                host_pop = HostExpPop(pop_h.t0, pop_h.n0, pop_h.g,
                                      pop_h.min_pop)
            t2 = time.perf_counter()
            parts = partition_tree(tree, self._last_cuts)
            B_parts = [parts[i] for i in B]
            self._topo_debt += int(self.host_rng.binomial(chunk, 2.0 / 30.0))
            budget = self._topo_debt
            self._topo_debt = 0
            dlg, acc, prop = run_bursts_on_parts(
                tree, parts, budget, host_pop, mu, nu, q, pi,
                self.host_rng, num_cells=min(self.num_cells, 400),
                parallel=self.topology_parallel_processes,
                part=part, q_tab=q_tab, do_reassemble=False,
                burst_idx=[int(i) for i in B])
            self.topology_accepted += acc
            self.topology_proposed += prop
            self.burst_count += 1
            t3 = time.perf_counter()

            # join L, merge: the device half from L's state, the host half
            # from the burst's part trees (disjoint supports)
            ints, flts = fused_l
            ts_h, _evo_h2, _pop_h2 = split_for_host(
                (ts_l, evo_l, pop_l), ints.cpu(), flts.cpu())
            t4 = time.perf_counter()
            tree_m = unpack_state(ts_h, names=self.names)
            reassemble(tree_m, B_parts)
            # same-site chain redraw on the host half's branches only (the
            # device may have moved the other half's branch ends)
            qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
            window = budget * 30.0 / 2.0
            rounds = max(1, round(window / max(1, cadence)))
            b_nodes = [int(g) for p in B_parts
                       for sn, g in enumerate(p.orig_index)
                       if sn != p.tree.root]
            dlg_chains = resample_multi_site_chains(
                tree_m, self.host_rng, mu, nu, part, qa_tab, rounds=rounds,
                nodes=b_nodes)
            rereference_to_root_sequence(tree_m)

            # ledger: L's (recompute + window deltas) + the burst's and the
            # chains' deltas; the plain log_coal of the merged tree (the
            # per-part augmented priors do not sum to it)
            hg = HostCoalGrid(tree_m, host_pop, min(self.num_cells, 400),
                              self.t_max_tip)
            self.ledger = ledger_l._replace(
                log_G=ledger_l.log_G + dlg + dlg_chains,
                log_coal=torch.as_tensor(hg.log_prior(tree_m.t),
                                         dtype=self.dtype,
                                         device=self.device))
            self.ts, self.evo, self.pop = ts_l, evo_l, pop_l
            self.last_stats = stats_l
            att = int(stats_l["local_moves_attempted"])
            self.local_moves_attempted += att + budget
            if att > 0:
                measured = (att / (boundaries * n_blocks) * n_real
                            / max(1, n_dev))
                self._per_block_rate = max(
                    1.0, 0.7 * self._per_block_rate + 0.3 * measured)

            # repack the merged tree and restencil for the next cycle
            self._adopt_tree(tree_m)
            self._boundaries_since_repart = 0
            t5 = time.perf_counter()
            self.last_cycle = {
                "boundaries": boundaries, "n_blocks": n_blocks,
                "parts_swept": n_dev, "selection_width": W,
                "parts_real": n_real, "burst_moves": budget,
                "local_moves": att, "enqueue_GL_s": t1 - t0,
                "wait_G_s": t2 - t1, "burst_s": t3 - t2,
                "join_L_s": t4 - t3, "merge_s": t5 - t4}
            done += chunk
        self.step += n_steps

    def _topology_num_parts(self) -> int:
        if self.topology_partitions > 0:
            return self.topology_partitions
        env = os.environ.get("DELPHY_TPU_TOPO_PARTS", "")
        if env:
            return max(1, int(env))
        T = self.ts.num_tips
        return max(1, min(2 * (os.cpu_count() or 1), T // 10),
                   min(1024, T // 100))

    def _topology_burst(self, n_moves: int):
        # one fused device->host transfer for everything the burst needs
        if self._fused_bundle is not None:
            ints, flts = self._fused_bundle
            ts_h, evo_h, pop_h = split_for_host(
                (self.ts, self.evo, self.pop), ints.cpu(), flts.cpu())
        else:
            ts_h, evo_h, pop_h = fetch_fused((self.ts, self.evo, self.pop))
        tree = unpack_state(ts_h, names=self.names)
        if isinstance(pop_h, popm.SkygridPopParams):
            host_pop = HostSkygridPop(pop_h.x, pop_h.gamma, pop_h.type)
        else:
            host_pop = HostExpPop(pop_h.t0, pop_h.n0, pop_h.g, pop_h.min_pop)
        mu, nu, q, pi = (float(evo_h.mu), np.asarray(evo_h.nu),
                         np.asarray(evo_h.q), np.asarray(evo_h.pi))
        part, q_tab = np.asarray(evo_h.part), np.asarray(evo_h.q_tab)
        num_cells = min(self.num_cells, 400)
        self.burst_count += 1

        P = self._topology_num_parts()
        if os.environ.get("DELPHY_TPU_TOPO_SINGLE", "0") == "1":
            P = 1
        if P > 1 and n_moves >= 16 * P:
            # partitioned phase: parts run on the native kernel's threads
            # (or, without it, on the Python mixer in worker processes)
            dlg, acc, prop = run_partitioned_bursts(
                tree, n_moves, P, host_pop, mu, nu, q, pi, self.host_rng,
                num_cells=num_cells,
                parallel=self.topology_parallel_processes, part=part,
                q_tab=q_tab)
            if self.ledger is not None:
                # the augmented per-part priors do not sum to the plain
                # prior: refresh log_coal from the post-burst tree
                hg = HostCoalGrid(tree, host_pop, num_cells, self.t_max_tip)
                self.ledger = self.ledger._replace(
                    log_G=self.ledger.log_G + dlg,
                    log_coal=torch.as_tensor(hg.log_prior(tree.t),
                                             dtype=self.dtype,
                                             device=self.device))
        else:
            res = run_burst_native(
                tree, n_moves, mu, nu, q, pi, host_pop,
                seed=int(self.host_rng.integers(2 ** 63)),
                can_change_root=True, num_cells=num_cells,
                t_max_tip=self.t_max_tip, part=part, q_tab=q_tab)
            if res is not None:
                dlg, dlc, acc, prop = res
            else:  # no native toolchain: the Python mixer
                mixer = TopologyMixer(tree, self.host_rng,
                                      num_cells=num_cells)
                mixer.run_burst(n_moves, mu, nu, q, pi, host_pop,
                                self.t_max_tip, part=part, q_tab=q_tab)
                dlg, dlc = mixer.delta_log_G, mixer.delta_log_coal
                acc, prop = mixer.n_accepted, mixer.n_proposed
            if self.ledger is not None:
                self.ledger = self.ledger._replace(
                    log_G=self.ledger.log_G + dlg,
                    log_coal=self.ledger.log_coal + dlc)
        self.topology_accepted += acc
        self.topology_proposed += prop
        # joint redraw of same-site mutation chains, the one slot class the
        # device reform cannot touch
        qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
        window = n_moves * 30.0 / 2.0
        rounds = max(1, round(window / max(1, self.local_moves_per_global_move)))
        dlg_chains = resample_multi_site_chains(tree, self.host_rng, mu, nu,
                                                part, qa_tab, rounds=rounds)
        if self.ledger is not None and dlg_chains != 0.0:
            self.ledger = self.ledger._replace(
                log_G=self.ledger.log_G + dlg_chains)
        # keep the reference sequence anchored at the root (log_G invariant)
        rereference_to_root_sequence(tree)
        self._adopt_tree(tree)

    def _adopt_tree(self, tree: FlatTree):
        """Make the host tree after a burst the run's state: grow the pool
        capacities, repack, reset the Euler positions, and rebuild the
        partition maps (the burst changed the topology)."""
        n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
        while n_muts > self.mut_capacity - 8:
            self.mut_capacity = _round_cap(2 * self.mut_capacity)
        n_ivs = sum(len(iv) for iv in tree.miss_intervals)
        while n_ivs > self.miss_capacity - 8:
            self.miss_capacity = _round_cap(2 * self.miss_capacity)
        n_fs = sum(len(fs) for fs in tree.miss_from_states)
        while n_fs > self.fs_capacity - 8:
            self.fs_capacity = _round_cap(2 * self.fs_capacity)
        self.ts = pack_state(tree, self.mut_capacity, self.miss_capacity,
                             self.fs_capacity, device=self.device,
                             dtype=self.dtype)
        self._fused_bundle = None
        self._set_euler(tree)
        self._host_tree = tree
        self._repartition()

    # -- observability --------------------------------------------------------

    @property
    def log_posterior(self) -> float:
        return float(self.ledger.log_posterior)

    def tree(self) -> FlatTree:
        return unpack_state(fetch_fused(self.ts), names=self.names)

    def calc_cur_ledger(self) -> Ledger:
        """Full from-scratch recompute of the ledger under the current
        parameters (run.cpp:316-338)."""
        return calc_ledger(self.ts, self.evo, self.pop,
                           torch.tensor(self.t_max_tip, dtype=self.dtype,
                                        device=self.device),
                           self.num_cells, self.hyp)

    def check_derived_quantities(self, tol: float = 1e-6):
        """The incrementally maintained log_G must match a full recompute
        (run.cpp:316-338).  Under a mesh every rank must call it: the ranks
        first compare log_G, the sum of t, topology_proposed and one draw of
        a copy of the host RNG, and raise on any difference."""
        if self.ledger is None:
            return
        if self.mesh is not None:
            probe = np.random.Generator(
                copy.deepcopy(self.host_rng.bit_generator))
            bad = self.mesh.disagreeing({
                "log_G": float(self.ledger.log_G),
                "sum of t": float(torch.sum(self.ts.t)),
                "topology_proposed": float(self.topology_proposed),
                "host RNG draw": probe.random()})
            if bad:
                raise AssertionError(f"rank {self.mesh.rank}: the ranks "
                                     f"disagree on {', '.join(bad)}")
        got = float(self.ledger.log_G)
        want = float(self.calc_cur_ledger().log_G)
        if not abs(got - want) < tol:
            raise AssertionError(f"log_G drift: {got} != {want}")

    def host_view(self) -> HostView:
        """``evo``, ``pop``, the ledger, the node times and the root on the
        host, in one device-to-host copy.  Host code (log and snapshot
        writers, the server's getters) reads a run's parameters through this
        instead of field by field: each ``float()`` of a device scalar is a
        sync of its own."""
        ledger = self.ledger if self.ledger is not None else ()
        muts = (self.last_stats["num_muts"],) if self.last_stats else ()
        evo, pop, led, t, root, muts = fetch_one(
            (self.evo, self.pop, ledger, self.ts.t, self.ts.root, muts))
        return HostView(evo=evo, pop=pop, ledger=led or None, t=t,
                        root=int(root),
                        num_muts=int(muts[0]) if muts else None)

    def stats_line(self, hv: HostView | None = None) -> str:
        hv = hv or self.host_view()
        led, pi, evo = hv.ledger, hv.evo.pi, hv.evo
        if isinstance(hv.pop, popm.SkygridPopParams):
            pop_str = (f"Nbar {float(np.exp(np.mean(hv.pop.gamma))):.2f}  "
                       f"tau {float(hv.pop.tau):.3f}")
        else:
            pop_str = (f"n0 {float(hv.pop.n0):.2f}  "
                       f"g {float(hv.pop.g) * 365.0:.3f}/yr")
        mpox = (f"mu* {float(evo.mu * evo.mpox_rho) * 365.0:.3e}/yr  "
                if self.mpox_hack else "")
        return (f"step {self.step}  log_post {float(led.log_posterior):.4f}  "
                f"log_G {float(led.log_G):.4f}  "
                f"log_coal {float(led.log_coal):.4f}  "
                f"muts {hv.num_muts}  "
                f"mu {float(evo.mu) * 365.0:.3e}/yr  {mpox}"
                f"kappa {float(evo.kappa):.3f}  "
                f"pi [{pi[0]:.2f} {pi[1]:.2f} {pi[2]:.2f} {pi[3]:.2f}]  "
                f"{pop_str}  "
                f"t_root {float(hv.t[hv.root]):.2f}")
