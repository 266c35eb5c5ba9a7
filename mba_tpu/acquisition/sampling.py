"""Serial sampling processes + accuracy sampler.

Parity targets (reference measurements_and_interactive_visuals.py):
- :func:`read_serial_measurements` — line-protocol parser with per-channel
  EMA smoothing and last-valid fallback (:73-186); byte parsing happens in
  the native C++ shim when available.
- :func:`dynamometer_volt_to_force` — calibration map
  F = 2.2·V^4.1071 (+offset) in kg or %MVC (:213-219).
- :func:`sampling_process` — acquisition loop: trigger commands 'A'/'B',
  shared-dict publication, redundant/interim/final CSV tiers (:320-356).
- :func:`dummy_sampling_process` — synthetic no-hardware backend
  (:361-453).
- :func:`accuracy_sampler` — squared-error sampler vs the target sine →
  RMSE CSV (:1783-1840).
"""
from __future__ import annotations

import glob
import math
import os
import time
from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu.utils import file_management as filemgmt

DYNAMOMETER_COEFF = 2.2
DYNAMOMETER_EXPONENT = 4.1071


def dynamometer_volt_to_force(volts: float, offset: float = 0.0,
                              mvc_kg: float | None = None) -> float:
    """Fitted power-law dynamometer calibration (reference :213-219).

    Returns kg, or %MVC when ``mvc_kg`` is given.
    """
    force_kg = DYNAMOMETER_COEFF * (volts ** DYNAMOMETER_EXPONENT) + offset
    if mvc_kg is not None and mvc_kg > 0:
        return 100.0 * force_kg / mvc_kg
    return force_kg


def mvc_live_force_mapping(v, _shared_dc_offset=None):
    """Module-level picklable force mapping for MVC calibration (no MVC
    value yet).  Parity: reference experiment_workflow.py:31-35 — the DC
    offset arrives as a ``multiprocessing`` shared value at runtime (a
    plain float or None also works)."""
    offset = (_shared_dc_offset.value
              if hasattr(_shared_dc_offset, "value")
              else float(_shared_dc_offset or 0.0))
    return dynamometer_volt_to_force(v, offset=offset, mvc_kg=None)


def live_force_mapping_factory(v, _mvc_kg=None, _shared_dc_offset=None):
    """Picklable %MVC force mapping for regular sampling (reference
    experiment_workflow.py:37-41)."""
    offset = (_shared_dc_offset.value
              if hasattr(_shared_dc_offset, "value")
              else float(_shared_dc_offset or 0.0))
    return dynamometer_volt_to_force(v, offset=offset, mvc_kg=_mvc_kg)


def probe_serial_device(pattern: str = "/dev/ttyACM*") -> str | None:
    """Return the first matching serial device path, or None.

    Mirrors the serial probe + dummy fallback at reference
    experiment_workflow.py:139-146.
    """
    matches = sorted(glob.glob(pattern))
    return matches[0] if matches else None


class read_serial_measurements:
    """Streaming parser for the Teensy line protocol with EMA smoothing.

    Each call to :meth:`feed` ingests raw bytes; :meth:`latest` returns the
    smoothed last sample (malformed lines keep the previous valid value —
    reference :120-150).  Uses the native C++ ring-buffer parser when the
    toolchain is available, a pure-Python fallback otherwise.
    """

    def __init__(self, ema_alpha: float = 0.3, use_native: bool = True):
        self.ema_alpha = ema_alpha
        self._smoothed = {"fsr": None, "ecg": None, "gsr": None}
        self._raw = {"fsr": None, "ecg": None, "gsr": None}
        self._native = None
        self.n_samples = 0
        if use_native:
            try:
                from mba_tpu.native.build import NativeLineParser
                self._native = NativeLineParser()
            except Exception as exc:
                print(f"[read_serial_measurements] native parser "
                      f"unavailable ({exc}); using Python fallback")
        self._partial = b""
        self._pending: dict[str, float] = {}

    def _ema(self, key: str, value: float) -> None:
        self._raw[key] = value
        prev = self._smoothed[key]
        self._smoothed[key] = (value if prev is None
                               else self.ema_alpha * value
                               + (1 - self.ema_alpha) * prev)

    def feed(self, data: bytes, t_mono: float | None = None) -> int:
        """Ingest bytes; returns number of completed samples."""
        t_mono = time.monotonic() if t_mono is None else t_mono
        if self._native is not None:
            n = self._native.feed(data, t_mono)
            for sample in self._native.poll():
                for key in ("fsr", "ecg", "gsr"):
                    if math.isfinite(sample[key]):
                        self._ema(key, sample[key])
            self.n_samples += n
            return n
        # Python fallback (sample-in-progress state survives split feeds)
        self._partial += data
        n_done = 0
        *lines, self._partial = self._partial.split(b"\n")
        for line in lines:
            text = line.strip().decode("ascii", errors="ignore")
            for key, prefix in (("fsr", "FSR:"), ("ecg", "ECG:"),
                                ("gsr", "GSR:")):
                if text.startswith(prefix):
                    try:
                        self._pending[key] = float(text[len(prefix):])
                    except ValueError:
                        pass
            if len(self._pending) == 3:
                for key, val in self._pending.items():
                    self._ema(key, val)
                self._pending = {}
                n_done += 1
                self.n_samples += 1
        return n_done

    def latest(self) -> dict:
        return {"fsr": self._smoothed["fsr"], "ecg": self._smoothed["ecg"],
                "gsr": self._smoothed["gsr"]}


def _tiered_saver(save_dir: Path, rows: list, final: bool = False,
                  interim_counter: int = 0) -> int:
    """Triple-tier crash-resilient saving (reference :341-352):
    Redundant (rolling overwrite) / Interim WorkMem Full / Final Save."""
    save_dir = Path(save_dir)
    filemgmt.assert_dir(save_dir)
    df = pd.DataFrame(rows)
    if "Time" in df.columns:
        # reference CSV format: timestamps as an UNNAMED index column
        # (the reference loader resolves the time column as the last
        # 'Unnamed' column, data_integration.py:1557-1573)
        df = df.set_index("Time")
        df.index.name = None
    if final:
        df.to_csv(save_dir / filemgmt.file_title(
            "Serial Measurements Final Save", ".csv"))
        return interim_counter
    # redundant rolling save: timestamped (undated filenames are
    # invisible to most_recent_file), previous rolls removed
    previous = sorted(save_dir.glob("*Redundant Save*.csv"))
    new_path = save_dir / filemgmt.file_title(
        "Serial Measurements Redundant Save", ".csv")
    # write then rename: a kill mid-write must not leave a truncated
    # file under the name the loaders look for
    tmp_path = new_path.with_suffix(".csv.partial")
    df.to_csv(tmp_path)
    os.replace(tmp_path, new_path)
    for old in previous:
        if old != new_path:          # same-second roll keeps the file
            old.unlink(missing_ok=True)
    return interim_counter


def _interim_saver(save_dir: Path, rows: list) -> None:
    """WorkMem-full interim tier, same CSV layout as the other tiers
    (timestamps as the unnamed index column)."""
    df = pd.DataFrame(rows)
    if "Time" in df.columns:
        df = df.set_index("Time")
        df.index.name = None
    df.to_csv(Path(save_dir) / filemgmt.file_title(
        "Serial Measurements Interim Save WorkMem Full", ".csv"))


def sampling_process(shared_dict, stop_event, save_dir,
                     serial_device: str | None = None,
                     sampling_rate_hz: float = 1000.0,
                     start_trigger_event=None, stop_trigger_event=None,
                     redundant_save_every_sec: float = 10.0,
                     interim_save_every_rows: int = 100_000,
                     run_for_sec: float | None = None) -> None:
    """Acquisition loop (reference :309-356).

    Reads the serial stream (native parser), publishes the latest smoothed
    sample into ``shared_dict``, writes trigger command bytes 'A'/'B' when
    the corresponding events fire, and maintains the triple-tier saves.
    Designed as a ``multiprocessing.Process`` target.
    """
    from mba_tpu.native.build import load_serialshim

    lib = None
    fd = -1
    if serial_device is not None:
        lib = load_serialshim()
        fd = lib.serial_open(serial_device.encode(), 115200)
        if fd < 0:
            print(f"[sampling] failed to open {serial_device} "
                  f"(errno {-fd}); falling back to dummy backend")
            return dummy_sampling_process(
                shared_dict, stop_event, save_dir,
                sampling_rate_hz=sampling_rate_hz,
                start_trigger_event=start_trigger_event,
                stop_trigger_event=stop_trigger_event,
                run_for_sec=run_for_sec)

    parser = read_serial_measurements()
    rows: list[dict] = []
    interim_counter = 0
    last_redundant = time.monotonic()
    t_start = time.monotonic()
    period = 1.0 / sampling_rate_hz

    try:
        while not stop_event.is_set():
            now = time.monotonic()
            if run_for_sec is not None and now - t_start > run_for_sec:
                break
            # trigger commands to the Teensy (reference :320-328)
            if start_trigger_event is not None \
                    and start_trigger_event.is_set():
                if fd >= 0:
                    lib.serial_write_byte(fd, ord('A'))
                shared_dict["last_trigger"] = ("A", now)
                start_trigger_event.clear()
            if stop_trigger_event is not None \
                    and stop_trigger_event.is_set():
                if fd >= 0:
                    lib.serial_write_byte(fd, ord('B'))
                shared_dict["last_trigger"] = ("B", now)
                stop_trigger_event.clear()

            if fd >= 0:
                lib.serial_read_into_parser(fd, parser._native._handle,
                                            now)
                for sample in parser._native.poll():
                    for key in ("fsr", "ecg", "gsr"):
                        if math.isfinite(sample[key]):
                            parser._ema(key, sample[key])
                    rows.append({"Time": pd.Timestamp.now(),
                                 **parser.latest()})
            latest = parser.latest()
            if latest["fsr"] is not None:
                shared_dict.update(latest)
                shared_dict["n_samples"] = parser.n_samples

            if now - last_redundant > redundant_save_every_sec and rows:
                interim_counter = _tiered_saver(save_dir, rows,
                                                final=False,
                                                interim_counter=
                                                interim_counter)
                last_redundant = now
            if len(rows) >= interim_save_every_rows:
                _interim_saver(save_dir, rows)
                rows = []
                interim_counter += 1
            time.sleep(period)
    finally:
        if rows:
            _tiered_saver(save_dir, rows, final=True,
                          interim_counter=interim_counter)
        if fd >= 0:
            lib.serial_close(fd)


def dummy_sampling_process(shared_dict, stop_event, save_dir,
                           sampling_rate_hz: float = 360.0,
                           start_trigger_event=None,
                           stop_trigger_event=None,
                           force_sine_hz: float = 0.1,
                           run_for_sec: float | None = None,
                           seed: int = 0) -> None:
    """Synthetic no-hardware backend (reference :361-453).

    Produces a 0.1 Hz force sine (as if tracking the task target), a
    ~70 bpm ECG pulse train, and a slow GSR drift — at the same line
    rate and with the same shared-dict/CSV contract as the real sampler.
    """
    rng = np.random.default_rng(seed)
    rows: list[dict] = []
    t_start = time.monotonic()
    # wall-clock anchor for row timestamps: burst back-fill stamps each
    # row at anchor + i·period (its synthesis time), not Timestamp.now()
    # — under host load now() would bunch a whole burst onto one instant,
    # skewing time-indexed downstream alignment
    wall_anchor = pd.Timestamp.now()
    last_redundant = t_start
    period = 1.0 / sampling_rate_hz
    n = 0
    while not stop_event.is_set():
        now = time.monotonic()
        t = now - t_start
        if run_for_sec is not None and t > run_for_sec:
            break
        if now - last_redundant > 2.0 and rows:
            # crash-resilient rolling save, same tiers as the real
            # sampler (reference :341-352)
            _tiered_saver(save_dir, rows, final=False)
            last_redundant = now
        if start_trigger_event is not None \
                and start_trigger_event.is_set():
            shared_dict["last_trigger"] = ("A", now)
            start_trigger_event.clear()
        if stop_trigger_event is not None \
                and stop_trigger_event.is_set():
            shared_dict["last_trigger"] = ("B", now)
            stop_trigger_event.clear()

        # hardware streams at the line rate whether or not the host
        # keeps up — emit every sample due by the wall clock (the real
        # serial reader drains the arrival burst the same way), so a
        # loaded 1-core host still yields fs samples/sec
        due = max(int(t * sampling_rate_hz) + 1, n + 1)
        sample = None
        for i in range(n, due):
            ti = i * period
            fsr = (1.5 + 0.5 * np.sin(2 * np.pi * force_sine_hz * ti)
                   + 0.02 * rng.standard_normal())
            # ~70 bpm with real rate variability (±4 bpm respiratory-ish
            # modulation): downstream HR/HRV features must see true
            # physiologic variation, not the timestamp jitter the old
            # now()-stamped rows leaked (the anchored stamps are exact)
            beat_phase = (ti * 70 / 60
                          + 0.35 * np.sin(2 * np.pi * 0.05 * ti)) % 1.0
            ecg = float(np.exp(-((beat_phase - 0.5) / 0.03) ** 2)
                        + 0.02 * rng.standard_normal())
            gsr = 2.0 + 0.1 * np.sin(2 * np.pi * 0.01 * ti) \
                + 0.01 * rng.standard_normal()
            sample = {"fsr": float(fsr), "ecg": ecg, "gsr": float(gsr)}
            rows.append({"Time": wall_anchor
                         + pd.Timedelta(seconds=ti), **sample})
        n = due
        # one shared-dict round-trip per burst (Manager IPC is the
        # per-iteration cost that made the old one-sample loop lag)
        shared_dict.update(sample)
        shared_dict["n_samples"] = n
        time.sleep(period)
    if rows:
        _tiered_saver(save_dir, rows, final=True)


def accuracy_sampler(shared_dict, stop_event, trial_dir,
                     target_frequency_hz: float,
                     min_pct_mvc: float = 7.5, max_pct_mvc: float = 22.5,
                     mvc_kg: float = 30.0,
                     sampling_rate_hz: float = 10.0,
                     start_offset_sec: float = 5.5,
                     run_for_sec: float | None = None) -> tuple:
    """Squared-error sampler vs the target sine → RMSE CSV
    (reference :1783-1840).

    Waits ``start_offset_sec`` (the sampler's warm-up; anchors the 5.5-s
    accuracy alignment constant in data_integration), then samples the
    shared force value against the moving target at ``sampling_rate_hz``.
    Returns (rmse, n_samples) and writes 'Trial Accuracy Results'.
    """
    period = 1.0 / sampling_rate_hz
    t_start = time.monotonic()
    sq_errors: list[float] = []
    mid = (min_pct_mvc + max_pct_mvc) / 2
    amp = (max_pct_mvc - min_pct_mvc) / 2
    while not stop_event.is_set():
        now = time.monotonic()
        t = now - t_start
        if run_for_sec is not None and t > run_for_sec:
            break
        if t < start_offset_sec:
            time.sleep(period)
            continue
        target = mid + amp * np.sin(2 * np.pi * target_frequency_hz
                                    * (t - start_offset_sec))
        volts = shared_dict.get("fsr")
        if volts is not None:
            actual = dynamometer_volt_to_force(volts, mvc_kg=mvc_kg)
            sq_errors.append(float((actual - target) ** 2))
        time.sleep(period)

    rmse = float(np.sqrt(np.mean(sq_errors))) if sq_errors else np.nan
    trial_dir = Path(trial_dir)
    filemgmt.assert_dir(trial_dir)
    pd.DataFrame({"Squared Error": sq_errors}).to_csv(
        trial_dir / filemgmt.file_title("Trial Accuracy Results", ".csv"))
    return rmse, len(sq_errors)
