"""Offline probe of the relativistic per-zone flux solve against
recorded smoothing inputs (MCS_SMOOTH_DUMP npz files).

Replays models/smoothing.new_velocity_profile zone by zone and reports
where the momentum/energy solves go negative or clamp, so solver
conditioning can be developed without re-running the science workload
(the gamma0=5 fixed point once froze at iteration 2).

Usage: python scripts/probe_smoothing_solve.py smooth_dumps_r5/smooth_inputs_iter02.npz
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from montecarloscattering_jl_tpu.utils.constants import C_CGS, MP_CGS


def analyze(path):
    d = np.load(path)
    nb = len(d["ux_sk"])
    lo, hi = 1, nb - 2
    f_px, f_en = float(d["f_px_up"]), float(d["f_en_up"])
    q_px = float(d["q_esc_px_avg"]) * d["pxx_flux"][lo]
    q_en = float(d["q_esc_en_avg"]) * d["energy_flux"][lo]
    n0 = float(d["rho0"]) / MP_CGS
    g0, b0 = float(d["gamma0"]), float(d["beta0"])
    omega = float(d["omega"])
    pxx, enf = d["pxx_flux"], d["energy_flux"]
    ux, gsf = d["ux_sk"], d["gamma_sf"]
    btot, theta = d["btot"], d["theta"]
    gg = d["gamma_grid"]
    ptot_mc = d["p_psd_par"] + d["p_psd_perp"]
    x = d["x_grid_rg"]

    print(f"{path}: i_iter={int(d['i_iter'])} pwf="
          f"{float(d['prof_weight_fac']):.3f} f_px_up={f_px:.4e}")
    print(f"{'i':>3} {'x_rg':>11} {'ux/u0':>7} {'Gpost':>7} "
          f"{'pxx/F':>7} {'pres/F':>8} {'rhs/F':>8} {'gb_px':>10} "
          f"{'gb_en':>10}")
    n_neg_px = n_neg_en = 0
    for i in range(lo, hi + 1):
        bx = btot[i] * math.cos(theta[i])
        bz = btot[i] * math.sin(theta[i])
        g = gsf[i]
        bu = ux[i] / C_CGS
        gb = g * bu
        gpost = max(gg[i, 1], 1.0 + 1e-6)
        xi = gpost / (gpost - 1.0)
        pxx_em = (gb**2 * btot[i]**2 / (8 * math.pi)
                  + g**2 * (bz**2 - bx**2) / (8 * math.pi))
        en_em = g**2 * bu * bz**2 / (4 * math.pi) * C_CGS
        density_loc = g0 * b0 / gb * n0
        pres_px = ((pxx[i] - gb**2 * density_loc * MP_CGS * C_CGS**2)
                   / (1.0 + gb**2 * xi))
        pres = (1.0 - omega) * pres_px + omega * ptot_mc[i]
        pres_c = max(pres, 1e-99)
        coeff = g0 * b0 * n0 * (MP_CGS * C_CGS**2
                                + pres_c * xi / density_loc)
        rhs = f_px - q_px - pxx_em - pres_c
        gb_px = rhs / coeff
        k = C_CGS * (density_loc * MP_CGS * C_CGS**2 + xi * pres_c)
        rhs_e = f_en - q_en - en_em
        a = rhs_e / k
        gb2 = (-1.0 + math.sqrt(1.0 + 4.0 * a * a)) / 2.0
        gb_en = math.copysign(math.sqrt(max(gb2, 0.0)), a)
        n_neg_px += gb_px < 0
        n_neg_en += gb_en < 0
        if abs(x[i]) < 1e29:
            print(f"{i:3d} {x[i]:11.3e} {ux[i]/float(d['u0']):7.4f} "
                  f"{gpost:7.4f} {pxx[i]/f_px:7.3f} {pres/f_px:8.3f} "
                  f"{rhs/f_px:8.3f} {gb_px:10.3e} {gb_en:10.3e}")
    print(f"negative solves: momentum {n_neg_px}, energy {n_neg_en} "
          f"of {hi - lo + 1}")


if __name__ == "__main__":
    for p in sys.argv[1:]:
        analyze(p)
