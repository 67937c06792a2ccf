"""<special><initialize> ops (JDsInitialize rebuild): fluid velocity
profiles + mDBC boundary-normal assignment from shapes / particles."""

import dataclasses
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.features.initialize import (
    InitBoundNormalCylinder, InitBoundNormalParts, InitBoundNormalPlane,
    InitBoundNormalSet, InitBoundNormalSphere, InitFluidVel,
    apply_initialize, parse_initialize_xml, parse_initnor_cli)
from dualsphysics_multilayer.typesdef import make_ctesph


@pytest.fixture
def csp():
    return make_ctesph(simulate2d=False, dp=0.1, hswl=0.5)


def _state(pos, code):
    from dualsphysics_multilayer.models.wcsph import SimState
    n = len(pos)
    return SimState(pos=jnp.asarray(pos, jnp.float64),
                    vel=jnp.zeros((n, 3), jnp.float32),
                    rho=jnp.full((n,), 1000.0, jnp.float32),
                    code=jnp.asarray(code, jnp.uint32),
                    idp=jnp.arange(n, dtype=jnp.uint32))


def test_fluidvel_profiles(csp):
    z = np.linspace(0.0, 1.0, 11)
    pos = np.column_stack([np.zeros_like(z), np.zeros_like(z), z])
    code = np.full(len(z), td.code_make(td.TYPE_FLUID, 0), np.uint32)
    st = _state(pos, code)
    # uniform
    st1 = apply_initialize([InitFluidVel(mkfluid=0, v=(2.0,))], csp, st)
    assert np.allclose(np.asarray(st1.vel)[:, 0], 2.0)
    # linear v(z): 1 at z=0 -> 3 at z=1
    st2 = apply_initialize([InitFluidVel(mkfluid=0, profile="linear",
                                         v=(1.0, 3.0), z=(0.0, 1.0))],
                           csp, st)
    assert abs(float(st2.vel[5, 0]) - 2.0) < 1e-6
    # parabolic through (0,0),(0.5,1),(1,0)
    st3 = apply_initialize([InitFluidVel(mkfluid=0, profile="parabolic",
                                         v=(0.0, 1.0, 0.0),
                                         z=(0.0, 0.5, 1.0))], csp, st)
    assert abs(float(st3.vel[5, 0]) - 1.0) < 1e-6
    assert abs(float(st3.vel[0, 0])) < 1e-6
    # wrong mk: untouched
    st4 = apply_initialize([InitFluidVel(mkfluid=7, v=(2.0,))], csp, st)
    assert np.allclose(np.asarray(st4.vel), 0.0)


def test_boundnormal_set_and_plane(csp):
    pos = np.array([[0.0, 0, 0], [0.1, 0, 0], [0.2, 0, 0],   # bound mk 1
                    [1.0, 0, 0]])                             # fluid
    code = np.array([td.code_make(td.TYPE_FIXED, 1)] * 3
                    + [td.code_make(td.TYPE_FLUID, 0)], np.uint32)
    st = _state(pos, code)
    st1 = apply_initialize([InitBoundNormalSet(mkbound=1,
                                               normal=(0, 0, 1))], csp, st)
    nm = np.asarray(st1.boundnormal)
    assert np.allclose(nm[:3], [0, 0, 1]) and np.allclose(nm[3], 0)
    # plane with explicit point at x=0.25, normal +x: distances 0.25,0.15,0.05
    st2 = apply_initialize([InitBoundNormalPlane(mkbound=1, normal=(1, 0, 0),
                                                 point=(0.25, 0, 0))],
                           csp, st)
    nm = np.asarray(st2.boundnormal)
    assert np.allclose(nm[:3, 0], [0.25, 0.15, 0.05], atol=1e-6)
    # auto point: outermost along +x (x=0.2) + 0.5*dp -> plane at 0.25
    st3 = apply_initialize([InitBoundNormalPlane(mkbound=1,
                                                 normal=(1, 0, 0))], csp, st)
    assert np.allclose(np.asarray(st3.boundnormal)[:3, 0],
                       [0.25, 0.15, 0.05], atol=1e-6)


def test_boundnormal_sphere_cylinder(csp):
    # bound ring inside a sphere shell of radius 0.5
    th = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pos = np.column_stack([0.4 * np.cos(th), 0.4 * np.sin(th),
                           np.zeros_like(th)])
    code = np.full(len(pos), td.code_make(td.TYPE_FIXED, 2), np.uint32)
    st = _state(pos, code)
    st1 = apply_initialize([InitBoundNormalSphere(mkbound=2, radius=0.5,
                                                  center=(0, 0, 0))], csp, st)
    nm = np.asarray(st1.boundnormal)
    # magnitude = 0.1 towards the surface, direction radial
    assert np.allclose(np.linalg.norm(nm, axis=1), 0.1, atol=1e-6)
    assert np.all((nm * pos).sum(1) > 0)
    st2 = apply_initialize([InitBoundNormalCylinder(
        mkbound=2, center1=(0, 0, -1), center2=(0, 0, 1), radius=0.5,
        limit1=False, limit2=False)], csp, st)
    nm2 = np.asarray(st2.boundnormal)
    assert np.allclose(np.linalg.norm(nm2, axis=1), 0.1, atol=1e-6)


def test_boundnormal_parts(csp):
    # wall slab: 3 layers in x, fluid on +x side -> normals point +x
    xs = [0.0, 0.1, 0.2]
    zs = np.arange(0, 1.0, 0.1)
    pos = np.array([[x, 0, z] for x in xs for z in zs])
    code = np.full(len(pos), td.code_make(td.TYPE_FIXED, 3), np.uint32)
    st = _state(pos, code)
    st1 = apply_initialize([InitBoundNormalParts(mkbound=3)], csp, st)
    nm = np.asarray(st1.boundnormal)
    # outer layer (x=0.2) normals point away from the slab (+x)
    outer = pos[:, 0] > 0.15
    inner_z = (pos[:, 2] > 0.2) & (pos[:, 2] < 0.8)
    assert np.all(nm[outer & inner_z, 0] > 0)


def test_parse_initialize_xml(csp):
    xml = """<initialize>
      <fluidvelocity mkfluid="0">
        <direction x="1" y="0" z="0"/>
        <velocity2 v="1" v2="3" z="0" z2="1"/>
      </fluidvelocity>
      <boundnormal_plane mkbound="2">
        <point x="1" y="0" z="0"/><normal x="1" y="0" z="0"/>
        <maxdisth v="2.0"/>
      </boundnormal_plane>
      <boundnormal_sphere mkbound="3">
        <center x="1" y="0" z="0"/><radius v="1"/><inside v="true"/>
      </boundnormal_sphere>
      <boundnormal_set mkbound="4" active="false">
        <normal x="1" y="0" z="0"/>
      </boundnormal_set>
    </initialize>"""
    ops = parse_initialize_xml(ET.fromstring(xml))
    assert len(ops) == 3                     # inactive op skipped
    assert isinstance(ops[0], InitFluidVel) and ops[0].profile == "linear"
    assert isinstance(ops[1], InitBoundNormalPlane)
    assert ops[1].point == (1.0, 0.0, 0.0)
    assert isinstance(ops[2], InitBoundNormalSphere)


def test_parse_initnor_cli():
    ops = parse_initnor_cli("mkbound=5-7,10:normal=0:0:1:maxdisth=1.5")
    assert len(ops) == 4
    assert all(o.normal == (0.0, 0.0, 1.0) for o in ops)
    assert ops[0].maxdisth == 1.5
    assert [o.mkbound for o in ops] == [5, 6, 7, 10]
    ops2 = parse_initnor_cli("mkbound=3", kind="parts")
    assert isinstance(ops2[0], InitBoundNormalParts)
