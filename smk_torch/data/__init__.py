"""Data sets of the port — twin of ``smk_tpu/data``: the presence/absence
(eBird) loader and proxy, numpy generators."""

from smk_torch.data.ebird import (
    PresenceAbsenceData,
    load_presence_absence_csv,
    make_ebird_proxy,
    write_presence_absence_csv,
)

__all__ = [
    "PresenceAbsenceData",
    "load_presence_absence_csv",
    "make_ebird_proxy",
    "write_presence_absence_csv",
]
