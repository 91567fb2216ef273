"""SBN-parameter model holder (vip/sbn_model.py parity; the counterpart of
libsbn_tpu.vi.sbn_model).

The reference's ``SBNModel`` is a stub holding a zero-copy numpy view of the
instance's flat sbn_parameters vector; the view stays live because the C++
vector is mutated in place. Here instance methods may REASSIGN the array
(train_simple_average etc.), so the model proxies the attribute instead of
capturing one array: ``model.sbn_parameters`` always aliases the instance's
current array, and in-place writes through it are seen by the instance.
The setter stores a writable float64 copy, so that assigning a read-only
array (a view of another buffer, an array with ``writeable=False``) keeps
that contract.
"""

import numpy as np


class SBNModel:
    def __init__(self, inst):
        self._inst = inst

    @property
    def sbn_parameters(self) -> np.ndarray:
        return self._inst.sbn_parameters

    @sbn_parameters.setter
    def sbn_parameters(self, value):
        self._inst.sbn_parameters = np.array(value, dtype=np.float64)
