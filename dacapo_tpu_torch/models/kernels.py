"""Non-CNN benchmark bodies + numpy goldens (copy of dacapo_tpu/models/kernels.py).

The bodies of the basic benchmark list (examples/benchmarks/{SobelFilter,
HarrisCornerDetection,LinearRegression,PolynomialRegression,Multivariate}.py)
over the port's tracer, parameterized by slot geometry so unit tests run the
same graphs at toy sizes; each `*_golden` is the plaintext model with the same
(cyclic-rotation) semantics. Copied with its line numbers kept: traced ops
record their source line.
"""

import numpy as np

from ..ir import trace as hc


# ------------------------------------------------------------- helpers
def _sum_elements(data, log_n):
    """Rotate-reduce sum of 2^log_n cyclic slots (reference sum_elements)."""
    for i in range(log_n):
        data = data + data.rotate(1 << i)
    return data


def _np_sum_elements(data, log_n):
    for i in range(log_n):
        data = data + np.roll(data, -(1 << i))
    return data


# --------------------------------------------------------------- Sobel
def sobel_body(image, w=64):
    """SobelFilter (examples/benchmarks/SobelFilter.py:9-27): 3x3 Sobel
    gradients + cubic polynomial magnitude approximation."""
    F = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    Ix = Iy = None
    for i in range(3):
        for j in range(3):
            rot = image.rotate(i * w + j)
            h = rot * float(F[i][j])
            v = rot * float(F[j][i])
            Ix = h if Ix is None else Ix + h
            Iy = v if Iy is None else Iy + v
    c = Ix * Ix + Iy * Iy
    return c * c * c * 0.173 - c * c * 1.098 + c * 2.214


def sobel_golden(image, w=64):
    F = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    Ix = np.zeros_like(image)
    Iy = np.zeros_like(image)
    for i in range(3):
        for j in range(3):
            rot = np.roll(image, -(i * w + j))
            Ix = Ix + rot * F[i][j]
            Iy = Iy + rot * F[j][i]
    c = Ix * Ix + Iy * Iy
    return 0.173 * c ** 3 - 1.098 * c ** 2 + 2.214 * c


# -------------------------------------------------------------- Harris
def harris_body(image, w=64):
    """HarrisCornerDetection (examples/benchmarks/HarrisCornerDetection.py):
    Sobel products, 3x3 window accumulation, det - 0.1*trace^2 response."""
    F = [[-1, 0.00001, 1], [-2, 0.00001, 2], [-1, 0.00001, 1]]
    Ix = Iy = None
    for i in range(3):
        for j in range(3):
            rot = image.rotate(i * w + j)
            h = rot * hc.Plain([F[i][j]])
            v = rot * hc.Plain([F[j][i]])
            Ix = h if Ix is None else Ix + h
            Iy = v if Iy is None else Iy + v
    IxIx, IyIy, IxIy = Ix * Ix, Iy * Iy, Ix * Iy
    Mxx = Myy = Mxy = None
    for i in range(3):
        for j in range(3):
            rxx = IxIx.rotate(i * w + j)
            ryy = IyIy.rotate(i * w + j)
            rxy = IxIy.rotate(i * w + j)
            Mxx = rxx if Mxx is None else Mxx + rxx
            Myy = ryy if Myy is None else Myy + ryy
            Mxy = rxy if Mxy is None else Mxy + rxy
    trace = Mxx + Myy
    det = Mxx * Myy + (-Mxy) * Mxy
    return det + hc.Plain([-0.1]) * (trace * trace)


def harris_golden(image, w=64):
    F = np.array([[-1, 0.00001, 1], [-2, 0.00001, 2], [-1, 0.00001, 1]])
    Ix = np.zeros_like(image)
    Iy = np.zeros_like(image)
    for i in range(3):
        for j in range(3):
            rot = np.roll(image, -(i * w + j))
            Ix = Ix + rot * F[i][j]
            Iy = Iy + rot * F[j][i]
    IxIx, IyIy, IxIy = Ix * Ix, Iy * Iy, Ix * Iy
    Mxx = np.zeros_like(image)
    Myy = np.zeros_like(image)
    Mxy = np.zeros_like(image)
    for i in range(3):
        for j in range(3):
            Mxx = Mxx + np.roll(IxIx, -(i * w + j))
            Myy = Myy + np.roll(IyIy, -(i * w + j))
            Mxy = Mxy + np.roll(IxIy, -(i * w + j))
    trace = Mxx + Myy
    return Mxx * Myy - Mxy * Mxy - 0.1 * trace * trace


# ------------------------------------------------- Linear regression (GD)
def linreg_body(x_data, y_data, log_n=12, n_mean=2048, epochs=2, lr=0.01):
    """2-epoch gradient descent under HE
    (examples/benchmarks/LinearRegression.py:12-37)."""
    W = hc.Plain([1.0])
    b = hc.Plain([0.0])
    learning_rate = hc.Plain([-lr])
    for _ in range(epochs):
        error = x_data * W + b - y_data
        gradW = _sum_elements(error * x_data * hc.Plain([1.0 / n_mean]), log_n)
        gradb = _sum_elements(error * hc.Plain([1.0 / n_mean]), log_n)
        W = W + learning_rate * gradW
        b = b + learning_rate * gradb
    return W, b


def linreg_golden(x, y, n_mean=2048, epochs=2, lr=0.01):
    W, b = 1.0, 0.0
    for _ in range(epochs):
        err = W * x + b - y
        W = W - lr * np.sum(err * x) / n_mean
        b = b - lr * np.sum(err) / n_mean
    return W, b


# --------------------------------------------- Polynomial regression (GD)
def polyreg_body(x_data, y_data, log_n=12, n_mean=2048, epochs=2, lr=0.0001):
    W = [hc.Plain([1.0]), hc.Plain([1.0]), hc.Plain([1.0])]
    learning_rate = hc.Plain([-lr])
    for _ in range(epochs):
        y_predict = W[0] + x_data * W[1] + x_data * x_data * W[2]
        e0 = y_predict + (-y_data)
        errs = [e0, e0 * x_data, e0 * x_data * x_data]
        errs = [e * hc.Plain([1.0 / n_mean]) for e in errs]
        grads = [_sum_elements(e, log_n) for e in errs]
        W = [W[i] + grads[i] * learning_rate for i in range(3)]
    return W[0], W[1], W[2]


def polyreg_golden(x, y, n_mean=2048, epochs=2, lr=0.0001):
    W = np.array([1.0, 1.0, 1.0])
    for _ in range(epochs):
        pred = W[0] + W[1] * x + W[2] * x * x
        e0 = pred - y
        grads = np.array([np.sum(e0), np.sum(e0 * x), np.sum(e0 * x * x)]) / n_mean
        W = W - lr * grads
    return W


# ------------------------------------------------ Multivariate regression
def multivariate_body(x0, x1, x2, y0, y1, y2, log_n=12, n_mean=2048,
                      epochs=2, lr=0.01):
    X = [x0, x1, x2]
    Y = [y0, y1, y2]
    W = [[hc.Plain([v]) for _ in range(3)] for v in (1.0, 1.5, 2.0)]
    learning_rate = hc.Plain([-lr])
    for _ in range(epochs):
        for j in range(3):
            wX = [X[i] * W[j][i] for i in range(3)]
            e0 = wX[0] + wX[1] + wX[2] + (-Y[j])
            errs = [_sum_elements(e0 * X[i], log_n) for i in range(3)]
            grads = [errs[i] * hc.Plain([1.0 / n_mean]) for i in range(3)]
            for i in range(3):
                W[j][i] = W[j][i] + grads[i] * learning_rate
    return tuple(W[j][i] for j in range(3) for i in range(3))


def multivariate_golden(X, Y, n_mean=2048, epochs=2, lr=0.01):
    W = np.array([[1.0] * 3, [1.5] * 3, [2.0] * 3])
    for _ in range(epochs):
        for j in range(3):
            e0 = W[j][0] * X[0] + W[j][1] * X[1] + W[j][2] * X[2] - Y[j]
            grads = np.array([np.sum(e0 * X[i]) for i in range(3)]) / n_mean
            W[j] = W[j] - lr * grads
    return W
