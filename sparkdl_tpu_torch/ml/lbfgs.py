"""L-BFGS with a zoom line search, in plain torch on one device.

The port's own copy of what the reference takes from optax:
``optax.lbfgs()`` at its defaults (memory 10, ``scale_init_precond=True``,
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")``), driven by the reference's loop
(``sparkdl_tpu/ml/classification.py::_fit_softmax``): the value and
gradient the line search ends on are reused as the next iteration's
(optax's ``value_and_grad_from_state``), and the loop goes on while
``i < max_iter`` and the global norm of the gradient carried from the
step before is ``> tol``. It is not ``torch.optim.LBFGS``, whose
iterates differ.

The parameters are one flat float32 vector; ``value_and_grad(x)``
returns the objective (a 0-d tensor) and its gradient (shaped as ``x``).
Everything stays on ``x``'s device. Where optax branches inside one
compiled program (``lax.cond``, ``lax.while_loop``), the scalar selects
here are ``torch.where`` on the device, and the host reads the loop's
flags once per line-search step (one device-to-host sync, counted in
:attr:`LBFGSResult.syncs`), plus once before the first iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# optax.lbfgs's and optax.scale_by_zoom_linesearch's defaults
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
LS_TOL = 0.0


@dataclass
class LBFGSResult:
    """Where the loop stopped: ``x``, the ``iterations`` taken (the
    reference's ``numIterations``), the line-search steps summed over
    them, the function evaluations, and the host syncs the loop made
    (one before the first iteration, one after each line-search step)."""

    x: torch.Tensor
    iterations: int
    linesearch_steps: int
    evaluations: int
    syncs: int
    steps_per_iteration: List[int] = field(default_factory=list)


class _Memory:
    """``scale_by_lbfgs``'s state: the last params and gradient, and the
    ring of parameter differences ``s``, gradient differences ``y`` and
    weights ``rho = 1 / yᵀs`` (0 where ``yᵀs == 0``). ``count`` is the
    number of updates made, known on the host."""

    def __init__(self, x: torch.Tensor) -> None:
        self.count = 0
        self.params = torch.zeros_like(x)
        self.grad = torch.zeros_like(x)
        self.s = torch.zeros((MEMORY_SIZE,) + x.shape, dtype=x.dtype,
                             device=x.device)
        self.y = torch.zeros_like(self.s)
        self.rho = torch.zeros(MEMORY_SIZE, dtype=x.dtype, device=x.device)

    def direction(self, grad: torch.Tensor, params: torch.Tensor
                  ) -> torch.Tensor:
        """``scale_by_lbfgs``'s update, then ``scale(-1)``: the memory
        takes the newest differences, then ``-P g`` by the two-loop
        recursion."""
        m = MEMORY_SIZE
        memory_idx = self.count % m
        prev_idx = (self.count - 1) % m
        if self.count > 0:
            ds = params - self.params
            dy = grad - self.grad
            sy = torch.dot(dy, ds)
            weight = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            self.s[prev_idx] = ds
            self.y[prev_idx] = dy
            self.rho[prev_idx] = weight
            den = torch.dot(dy, dy)
            gamma = torch.where(den > 0.0, sy / den, torch.ones_like(den))
        else:
            # optax writes zeros into slot m - 1 at the first update; the
            # ring starts zeroed, so there is nothing to write
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad),
                                max=1.0)
        order = [(memory_idx + j) % m for j in range(m)]
        q = grad
        alphas = [None] * m
        for j in reversed(range(m)):
            i = order[j]
            alpha = self.rho[i] * torch.dot(self.s[i], q)
            q = q + (-alpha) * self.y[i]
            alphas[j] = alpha
        q = gamma * q
        for j in range(m):
            i = order[j]
            beta = self.rho[i] * torch.dot(self.y[i], q)
            q = q + (alphas[j] - beta) * self.s[i]
        self.count += 1
        self.params = params
        self.grad = grad
        return -q


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none; then it is not used)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    e1 = fb - fa - C * db
    e2 = fc - fa - C * dc
    A = (dc ** 2 * e1 + (-(db ** 2)) * e2) / denom
    B = ((-(dc ** 3)) * e1 + db ** 3 * e2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = (value_step - value_init
                    - APPROX_DEC_RTOL * torch.abs(value_init))
    approx = torch.maximum(approx, delta_values)
    err = torch.minimum(approx, err)
    err = torch.clamp(err, min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _curvature_error(slope_step, slope_init):
    err = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
    err = torch.clamp(err, min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


class _ZoomSearch:
    """``optax.zoom_linesearch``'s state and steps for one direction:
    the interval search (Nocedal and Wright, Algorithm 3.5) until an
    interval is found, then the zoom (Algorithm 3.6) with cubic, then
    quadratic, then bisection steps inside safeguards; after
    ``MAX_LINESEARCH_STEPS`` steps without both Wolfe conditions, the
    last point with sufficient decrease (the safe step) where there is
    one."""

    def __init__(self, params, updates, value, grad,
                 value_and_grad: ValueAndGrad) -> None:
        self.vg = value_and_grad
        self.count = 0
        self.evaluations = 0
        self.params = params
        self.updates = updates
        slope = torch.dot(updates, grad)
        zero = torch.zeros_like(value)
        self.stepsize_guess = torch.ones_like(value)
        self.stepsize = zero
        self.value = value
        self.grad = grad
        self.slope = slope
        self.value_init = value
        self.slope_init = slope
        inf = torch.full_like(value, float("inf"))
        self.decrease_error = inf
        self.curvature_error = inf
        self.done = torch.zeros((), dtype=torch.bool, device=value.device)
        self.failed = self.done
        self.interval_found = False  # host-side: it picks the branch
        self.low, self.value_low, self.slope_low = zero, value, slope
        self.high, self.value_high, self.slope_high = zero, value, slope
        self.cubic_ref, self.value_cubic_ref = zero, value
        self.safe_stepsize, self.safe_value, self.safe_grad = \
            zero, value, grad

    def _on_line(self, stepsize):
        step = self.params + stepsize * self.updates
        value, grad = self.vg(step)
        self.evaluations += 1
        return value, grad, torch.dot(grad, self.updates)

    def _search_interval(self) -> torch.Tensor:
        first = self.count == 0
        prev_stepsize, prev_value, prev_slope = \
            self.stepsize, self.value, self.slope
        new_stepsize = (self.stepsize_guess if first
                        else INCREASE_FACTOR * prev_stepsize)
        value, grad, slope = self._on_line(new_stepsize)
        dec = _decrease_error(new_stepsize, value, slope, self.value_init,
                              self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        error = torch.maximum(dec, curv)
        safe = dec <= LS_TOL
        self.safe_stepsize = torch.where(
            safe, new_stepsize, self.safe_stepsize)
        self.safe_value = torch.where(safe, value, self.safe_value)
        self.safe_grad = torch.where(safe, grad, self.safe_grad)
        set_high_to_new = (dec > 0.0) | ((value >= prev_value) & (not first))
        set_low_to_new = (slope >= 0.0) & ~set_high_to_new
        # default: low = prev, high = new; set_low_to_new swaps them
        self.low = torch.where(set_low_to_new, new_stepsize, prev_stepsize)
        self.value_low = torch.where(set_low_to_new, value, prev_value)
        self.slope_low = torch.where(set_low_to_new, slope, prev_slope)
        self.high = torch.where(set_low_to_new, prev_stepsize, new_stepsize)
        self.value_high = torch.where(set_low_to_new, prev_value, value)
        self.slope_high = torch.where(set_low_to_new, prev_slope, slope)
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        interval_found = set_high_to_new | set_low_to_new | (error <= LS_TOL)
        self.done = error <= LS_TOL
        self.failed = (self.count + 1 >= MAX_LINESEARCH_STEPS) & ~self.done
        self.stepsize, self.value, self.grad, self.slope = \
            new_stepsize, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv
        return interval_found

    def _zoom_into_interval(self) -> None:
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = \
            self.high, self.value_high, self.slope_high
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = delta <= STEPSIZE_PRECISION
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 self.cubic_ref, self.value_cubic_ref)
        use_cubic = ((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = (~use_cubic & (middle_quad > left + quad_chk)
                    & (middle_quad < right - quad_chk))
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, middle_cubic, self.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)
        value, grad, slope = self._on_line(middle)
        dec = _decrease_error(middle, value, slope, self.value_init,
                              self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        error = torch.maximum(dec, curv)
        update_safe = (dec <= LS_TOL) & (value < self.safe_value)
        self.safe_stepsize = torch.where(
            update_safe, middle, self.safe_stepsize)
        self.safe_value = torch.where(update_safe, value, self.safe_value)
        self.safe_grad = torch.where(update_safe, grad, self.safe_grad)
        self.done = error <= LS_TOL
        set_high_to_middle = (dec > 0.0) | (value >= value_low)
        set_high_to_low = ((slope * (high - low) >= 0.0)
                           & ~set_high_to_middle)
        set_low_to_middle = ~set_high_to_middle
        new_high = torch.where(set_high_to_middle, middle, high)
        new_value_high = torch.where(set_high_to_middle, value, value_high)
        new_slope_high = torch.where(set_high_to_middle, slope, slope_high)
        self.high = torch.where(set_high_to_low, low, new_high)
        self.value_high = torch.where(
            set_high_to_low, value_low, new_value_high)
        self.slope_high = torch.where(
            set_high_to_low, slope_low, new_slope_high)
        self.low = torch.where(set_low_to_middle, middle, low)
        self.value_low = torch.where(set_low_to_middle, value, value_low)
        self.slope_low = torch.where(set_low_to_middle, slope, slope_low)
        moved_high = set_high_to_middle | set_high_to_low
        self.cubic_ref = torch.where(moved_high, high, low)
        self.value_cubic_ref = torch.where(moved_high, value_high, value_low)
        presumably_failed = ((self.count + 1 >= MAX_LINESEARCH_STEPS)
                             | (too_small_int & (self.safe_stepsize > 0.0)))
        self.failed = presumably_failed & ~self.done
        self.stepsize, self.value, self.grad, self.slope = \
            middle, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv

    def step(self) -> torch.Tensor:
        """One line-search step; returns the device flag ``interval
        found`` (the zoom leaves it as it was)."""
        if self.interval_found:
            self._zoom_into_interval()
            found = torch.ones((), dtype=torch.bool,
                               device=self.done.device)
        else:
            found = self._search_interval()
        self.count += 1
        # a failed search falls back to the safe step (sufficient decrease
        # only) where it has one, or where it could not even evaluate
        take_safe = self.failed & ((self.safe_stepsize > 0.0)
                                   | torch.isinf(self.decrease_error))
        self.stepsize = torch.where(
            take_safe, self.safe_stepsize, self.stepsize)
        self.value = torch.where(take_safe, self.safe_value, self.value)
        self.grad = torch.where(take_safe, self.safe_grad, self.grad)
        return found


def minimize(value_and_grad: ValueAndGrad, x0: torch.Tensor, *,
             max_iter: int, tol: float,
             callback: Optional[Callable[[int, torch.Tensor], None]] = None
             ) -> LBFGSResult:
    """Minimize from ``x0`` (a flat float tensor) on its device.

    The loop is the reference's: with ``g`` the gradient at the start of
    the previous iteration (at ``x0`` before the first), iterate while
    ``i < max_iter`` and ``||g|| > tol``; each iteration computes the
    L-BFGS direction, runs the zoom line search from a step of 1.0, and
    moves ``x`` by the step it returns. ``callback(i, x)`` sees each
    iterate after iteration ``i`` (0-based).
    """
    x = x0
    value, grad = value_and_grad(x)
    evaluations = 1
    memory = _Memory(x)
    syncs = 1
    go_on = bool(torch.linalg.vector_norm(grad) > tol) and max_iter > 0
    steps: List[int] = []
    i = 0
    while go_on:
        # the carried gradient's norm, read with the line search's flags
        carry_ok = torch.linalg.vector_norm(grad) > tol
        direction = memory.direction(grad, x)
        search = _ZoomSearch(x, direction, value, grad, value_and_grad)
        while True:
            found = search.step()
            flags = torch.stack([search.done | search.failed, found,
                                 torch.isfinite(search.value), carry_ok])
            stop, found_host, finite, carry_host = flags.tolist()
            syncs += 1
            search.interval_found = found_host
            if stop:
                break
        evaluations += search.evaluations
        steps.append(search.count)
        x = x + search.stepsize * direction
        i += 1
        if callback is not None:
            callback(i - 1, x)
        go_on = i < max_iter and carry_host
        value, grad = search.value, search.grad
        if go_on and not finite:
            # value_and_grad_from_state recomputes a non-finite value
            value, grad = value_and_grad(x)
            evaluations += 1
    return LBFGSResult(x=x, iterations=i, linesearch_steps=sum(steps),
                       evaluations=evaluations, syncs=syncs,
                       steps_per_iteration=steps)
