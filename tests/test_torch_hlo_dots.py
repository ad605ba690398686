"""The dot counter that holds the port's matmul FLOPs to the reference's
partitioned HLO (``tests/hlo_dots.py``): each dot counted once for every
run of the computation that holds it, a ``while`` body once a trip.

The module's text is hand-written in the layout of ``compiled.as_text()``;
the test imports no JAX.
"""
import pytest

from hlo_dots import computations, dots

# An entry computation with a 2-D dot (2 x 4 x 8 x 16 = 1,024 FLOPs), a
# fusion holding a batched dot (2 x 3 x 4 x 5 x 6 = 720), and a scan of 8
# trips whose body holds a batched dot (2 x 2 x 4 x 4 x 32 = 2,048) and
# calls a fusion holding a 2-D dot (2 x 4 x 4 x 4 = 128).
_HLO = """HloModule jit_f, entry_computation_layout={(f32[4,16]{1,0})->f32[]}

%fused_dot (p.0: f32[3,4,6], p.1: f32[3,6,5]) -> f32[3,4,5] {
  %p.0 = f32[3,4,6]{2,1,0} parameter(0)
  %p.1 = f32[3,6,5]{2,1,0} parameter(1)
  ROOT %dot.2 = f32[3,4,5]{2,1,0} dot(%p.0, %p.1), lhs_batch_dims={0}, lhs_contracting_dims={2}, rhs_batch_dims={0}, rhs_contracting_dims={1}
}

%inner (q.0: f32[4,4], q.1: f32[4,4]) -> f32[4,4] {
  %q.0 = f32[4,4]{1,0} parameter(0)
  %q.1 = f32[4,4]{1,0} parameter(1)
  ROOT %dot.4 = f32[4,4]{1,0} dot(%q.0, %q.1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%body (b.0: (s32[], f32[2,4,32])) -> (s32[], f32[2,4,32]) {
  %b.0 = (s32[], f32[2,4,32]{2,1,0}) parameter(0)
  %x.1 = f32[2,4,32]{2,1,0} get-tuple-element(%b.0), index=1
  %dot.3 = f32[2,4,4]{2,1,0} dot(%x.1, %x.1), lhs_batch_dims={0}, lhs_contracting_dims={2}, rhs_batch_dims={0}, rhs_contracting_dims={2}
  %m.1 = f32[4,4]{1,0} bitcast(%dot.3)
  %fusion.2 = f32[4,4]{1,0} fusion(%m.1, %m.1), kind=kOutput, calls=%inner
  ROOT %t.1 = (s32[], f32[2,4,32]{2,1,0}) tuple(%i.1, %x.1)
}

%cond (c.0: (s32[], f32[2,4,32])) -> pred[] {
  %c.0 = (s32[], f32[2,4,32]{2,1,0}) parameter(0)
  ROOT %lt.1 = pred[] compare(%i.2, %n.1), direction=LT
}

ENTRY %main.9 (a.0: f32[4,16]) -> f32[] {
  %a.0 = f32[4,16]{1,0} parameter(0)
  %w.0 = f32[16,8]{1,0} constant({...})
  %dot.1 = f32[4,8]{1,0} dot(%a.0, %w.0), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %fusion.1 = f32[3,4,5]{2,1,0} fusion(%l.0, %r.0), kind=kOutput, calls=%fused_dot
  %while.1 = (s32[], f32[2,4,32]{2,1,0}) while(%tuple.1), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"8"},"known_init_step":{"init":"0","step":"1"}}
  ROOT %r.1 = f32[] reduce(%dot.1, %zero), dimensions={0,1}, to_apply=%add
}

%add (x: f32[], y: f32[]) -> f32[] {
  ROOT %s.1 = f32[] add(%x, %y)
}
"""


def test_computations_split_the_module():
    comps, entry = computations(_HLO)
    assert entry == "main.9"
    assert set(comps) == {"fused_dot", "inner", "body", "cond", "main.9",
                          "add"}
    assert len(comps["body"]) == 6


@pytest.mark.parametrize("trips", [1, 8, 512])
def test_loop_body_counted_once_a_trip(trips):
    hlo = _HLO.replace('"n":"8"', f'"n":"{trips}"')
    total, two_d = dots(hlo)
    assert total == 1_024 + 720 + trips * (2_048 + 128)
    assert two_d == 1_024 + trips * 128


def test_loop_without_a_known_trip_count_raises():
    hlo = _HLO.replace('"known_trip_count":{"n":"8"},', "")
    with pytest.raises(ValueError, match="no known trip count"):
        dots(hlo)


def test_computation_called_twice_counted_twice():
    hlo = _HLO.replace(
        "  %while.1 =",
        "  %fusion.3 = f32[3,4,5]{2,1,0} fusion(%l.0, %r.0), kind=kOutput, "
        "calls=%fused_dot\n  %while.1 =")
    assert dots(hlo)[0] == 1_024 + 2 * 720 + 8 * (2_048 + 128)
