"""URDF -> RobotModel: the pluggable-robot seam (counterpart of
mpcgpu_tpu/models/urdf.py, numpy and xml.etree only).

``model_from_urdf(path_or_text)`` parses a serial-chain URDF
(revolute/continuous joints), rotates every joint frame so the joint axis
is local +z (the convention of models/dynamics.py: motion subspace S =
e_z), and emits the affine sin/cos decomposition tables

    X_i(q_i) = Xc[i] + sin(q_i) Xs[i] + cos(q_i) Xk[i]   (6x6 spatial)
    H_i(q_i) = Hc[i] + sin(q_i) Hs[i] + cos(q_i) Hk[i]   (4x4 homogeneous)

plus 6x6 spatial inertias -- the table format of the IIWA-14 model
(models/iiwa14_params.py).  Every solver path consumes the model only
through these tables: the plain modules at any joint count, the CUDA
kernels at 2-7 joints (ops/cuda/_lib.py builds a library per count).

Frame rotation: for joint axis a, pick any rotation C with C e_z = a and
redefine the child frame as (child o C).  Then the joint rotation becomes
Rz(q), the fixed tree transform becomes C_prev^T T_origin C, and the
child link's inertial quantities are rotated by C^T.  A fixed end-effector
joint hanging off the last link is folded into the last hom transform.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from mpcgpu_tpu_torch.models.robot import RobotModel, robot_from_numpy


def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _hom(R, p):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def _axis_to_z_rotation(a):
    """Rotation C with C @ e_z = a (any valid choice)."""
    a = np.asarray(a, float)
    a = a / np.linalg.norm(a)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, a)
    c = float(z @ a)
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # antiparallel: rotate pi about x
        return np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def _parse_vec(s, default="0 0 0"):
    return np.array([float(x) for x in (s or default).split()])


def parse_urdf(source):
    """Parse a URDF (file path or XML text).

    Returns the serial chain: list of joints with fixed transforms and
    per-link inertial data (already in the rotated z-axis frames), plus
    the fixed end-effector offset transform.
    """
    s = str(source)
    root = (ET.fromstring(s) if s.lstrip().startswith("<")
            else ET.parse(s).getroot())
    links = {l.get("name"): l for l in root.findall("link")}
    joints = [j for j in root.findall("joint")
              if j.get("type") in ("revolute", "continuous")]
    fixed = [j for j in root.findall("joint") if j.get("type") == "fixed"]

    # order the chain from the root
    children = {j.find("parent").get("link"): j for j in joints}
    parents_of = {j.find("child").get("link") for j in joints}
    roots = [l for l in links if l not in parents_of]
    chain = []
    cur = None
    for r in roots:
        if r in children:
            cur = r
            break
    assert cur is not None, "no chain root found"
    while cur in children:
        j = children[cur]
        chain.append(j)
        cur = j.find("child").get("link")

    # optional fixed end-effector offset hanging off the last link
    ee_offset = np.eye(4)
    for j in fixed:
        if j.find("parent").get("link") == cur:
            o = j.find("origin")
            ee_offset = _hom(
                _rpy_matrix(_parse_vec(o.get("rpy") if o is not None
                                       else None)),
                _parse_vec(o.get("xyz") if o is not None else None),
            )
            break

    out = []
    C_prev = np.eye(3)
    for j in chain:
        o = j.find("origin")
        T_origin = _hom(
            _rpy_matrix(_parse_vec(o.get("rpy") if o is not None else None)),
            _parse_vec(o.get("xyz") if o is not None else None),
        )
        ax = j.find("axis")
        a = _parse_vec(ax.get("xyz") if ax is not None else None, "0 0 1")
        C = _axis_to_z_rotation(a)

        # fixed tree transform in rotated frames: C_prev^T * T_origin * C
        A = _hom(C_prev.T, np.zeros(3)) @ T_origin @ _hom(C, np.zeros(3))

        # child link inertia, rotated into the new child frame by C^T
        link = links[j.find("child").get("link")]
        inertial = link.find("inertial")
        m = float(inertial.find("mass").get("value"))
        io = inertial.find("origin")
        com = _parse_vec(io.get("xyz") if io is not None else None)
        irpy = _parse_vec(io.get("rpy") if io is not None else None)
        ine = inertial.find("inertia")
        Ic = np.array(
            [
                [float(ine.get("ixx")), float(ine.get("ixy", "0") or 0),
                 float(ine.get("ixz", "0") or 0)],
                [float(ine.get("ixy", "0") or 0), float(ine.get("iyy")),
                 float(ine.get("iyz", "0") or 0)],
                [float(ine.get("ixz", "0") or 0),
                 float(ine.get("iyz", "0") or 0), float(ine.get("izz"))],
            ]
        )
        R_i = _rpy_matrix(irpy)
        Ic_link = R_i @ Ic @ R_i.T       # at COM, in link frame
        com_r = C.T @ com                # in rotated frame
        Ic_r = C.T @ Ic_link @ C

        cx = np.array([[0, -com_r[2], com_r[1]],
                       [com_r[2], 0, -com_r[0]],
                       [-com_r[1], com_r[0], 0]])
        I6 = np.zeros((6, 6))
        I6[:3, :3] = Ic_r + m * cx @ cx.T
        I6[:3, 3:] = m * cx
        I6[3:, :3] = m * cx.T
        I6[3:, 3:] = m * np.eye(3)

        out.append({"A": A, "I6": I6, "name": j.get("name")})
        C_prev = C

    ee_offset = _hom(C_prev.T, np.zeros(3)) @ ee_offset
    return out, ee_offset


def build_tables(chain, ee_offset):
    """Affine sin/cos decomposition by probing q in {0, pi/2, pi}."""
    nj = len(chain)
    Rz = lambda q: np.array(
        [[np.cos(q), -np.sin(q), 0], [np.sin(q), np.cos(q), 0], [0, 0, 1]]
    )

    def hom(i, q):
        return chain[i]["A"] @ _hom(Rz(q), np.zeros(3))

    def dhom(i, q):
        dRz = np.array(
            [[-np.sin(q), -np.cos(q), 0], [np.cos(q), -np.sin(q), 0],
             [0, 0, 0]]
        )
        D = np.zeros((4, 4))
        D[:3, :3] = dRz
        return chain[i]["A"] @ D

    def spatial(i, q):
        H = hom(i, q)
        R, p = H[:3, :3], H[:3, 3]
        px = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
        X = np.zeros((6, 6))
        X[:3, :3] = R.T
        X[3:, 3:] = R.T
        X[3:, :3] = -R.T @ px
        return X

    def decompose(f):
        f0, f90, f180 = f(0.0), f(np.pi / 2), f(np.pi)
        Fc = (f0 - f180) / 2
        F0 = (f0 + f180) / 2
        Fs = f90 - F0
        # verify affineness at a probe angle
        q = 0.7318
        assert np.allclose(f(q), F0 + np.sin(q) * Fs + np.cos(q) * Fc,
                           atol=1e-10)
        return F0, Fs, Fc

    tables = {k: [] for k in
              ("Xc", "Xs", "Xk", "I", "Hc", "Hs", "Hk", "dHc", "dHs", "dHk")}
    for i in range(nj):
        F0, Fs, Fc = decompose(lambda q, i=i: spatial(i, q))
        tables["Xc"].append(F0)
        tables["Xs"].append(Fs)
        tables["Xk"].append(Fc)
        H0, Hs, Hk = decompose(lambda q, i=i: hom(i, q))
        tables["Hc"].append(H0)
        tables["Hs"].append(Hs)
        tables["Hk"].append(Hk)
        d0, ds, dk = decompose(lambda q, i=i: dhom(i, q))
        tables["dHc"].append(d0)
        tables["dHs"].append(ds)
        tables["dHk"].append(dk)
        tables["I"].append(chain[i]["I6"])
    # fold the fixed end-effector offset into the LAST hom transform
    for key in ("Hc", "Hs", "Hk", "dHc", "dHs", "dHk"):
        tables[key][-1] = tables[key][-1] @ ee_offset
    return {k: np.asarray(v) for k, v in tables.items()} | {"num_joints": nj}


def model_from_urdf(source, device="cuda", dtype=torch.float32) -> RobotModel:
    """RobotModel from a URDF file path or XML text (serial chain,
    revolute/continuous joints, any joint count), on the card unless the
    caller names another device."""
    return robot_from_numpy(build_tables(*parse_urdf(source)), device, dtype)
