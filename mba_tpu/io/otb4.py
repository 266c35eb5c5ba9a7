"""OTB4 (OT Bioelettronica) archive import.

Parity target: reference ``src/pipeline/otb_file_handling.py:178-444``.
An ``.otb4`` file is a tar archive containing ``Tracks_000.xml`` metadata
plus one or more ``.sig`` binary streams.  Semantics preserved bit-exactly:

- XML: ``ArrayOfTrackInfo/TrackInfo`` records with Gain, ADC_Nbits,
  ADC_Range, SamplingFrequency, SignalStreamPath, NumberOfChannels
  (otb_file_handling.py:287-302) — parsed here with stdlib ElementTree
  (the reference used xmltodict).
- Binary: int32 Fortran-order (channels, samples) for Novecento+ multi-block
  devices (otb_file_handling.py:337-384), int16 otherwise (:387-425).
- ADC→mV: ``raw * ADC_Range / 2**ADC_Nbits * 1000 / Gain``
  (otb_file_handling.py:361-368, 402-409).
- CSV export: ``Time_s`` column + 1-based ``Channel_<i>`` columns
  (otb_file_handling.py:117-146).
"""
from __future__ import annotations

import os
import shutil
import tarfile
import tempfile
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import pandas as pd


def _parse_tracks_xml(xml_source) -> list[dict]:
    """Parse Tracks_000.xml (path or file object) into per-track dicts."""
    root = ET.parse(xml_source).getroot()

    def strip_ns(tag: str) -> str:
        return tag.split('}', 1)[-1]

    tracks = []
    for node in root:
        if strip_ns(node.tag) != 'TrackInfo':
            continue
        rec = {}
        for child in node.iter():
            if len(child) == 0 and child.text is not None:
                rec[strip_ns(child.tag)] = child.text
        tracks.append(rec)
    if not tracks:
        raise FileNotFoundError("No TrackInfo records in Tracks_000.xml")
    return tracks


def _adc_to_mv(data: np.ndarray, track_slices: list[tuple[int, int, dict]]
               ) -> np.ndarray:
    """Apply per-track ADC→mV conversion in place."""
    for start, stop, trk in track_slices:
        factor = (float(trk['ADC_Range']) / (2 ** int(trk['ADC_Nbits']))
                  * 1000.0 / float(trk['Gain']))
        data[start:stop, :] *= np.float32(factor)
    return data


def _track_factors(track_slices: list[tuple[int, int, dict]],
                   n_ch: int) -> np.ndarray:
    """Per-channel ADC→mV factor vector (reference formula,
    otb_file_handling.py:361-368)."""
    factors = np.empty(n_ch, np.float32)
    for start, stop, trk in track_slices:
        factors[start:stop] = (float(trk['ADC_Range'])
                               / (2 ** int(trk['ADC_Nbits']))
                               * 1000.0 / float(trk['Gain']))
    return factors


def _decode_sig(raw: np.ndarray, n_ch: int,
                track_slices: list[tuple[int, int, dict]],
                raw_counts: bool) -> tuple[np.ndarray, np.ndarray]:
    """Decode a flat .sig buffer into (data (n_ch, n_samples), factors).

    The on-disk layout is sample-major (each sample's channels
    contiguous), i.e. already C-order ``(n_samples, n_ch)``:

    - ``raw_counts``: the count matrix is a zero-copy transposed VIEW of
      the buffer — import costs one tar memcpy, nothing else.
    - float path: ``reshape((-1, n_ch)).astype(f32)`` copies
      contiguously (the old ``reshape((n_ch, -1), order='F').astype``
      forced a strided transpose copy — ~3× slower at study scale),
      then one vectorized per-channel mV multiply; values are
      bit-identical to the old per-track in-place scaling.
    """
    factors = _track_factors(track_slices, n_ch)
    counts = raw.reshape((-1, n_ch))                 # zero-copy view
    if raw_counts:
        return counts.T, factors
    data = counts.astype(np.float32)                 # contiguous copy
    data *= factors[None, :]
    return data.T, factors


def read_otb4(otb4_path: str | Path, verbose: bool = False,
              raw_counts: bool = False) -> dict:
    """Read an OTB4 archive into memory.

    Returns dict with:
      - ``signals``: list of (name, data (channels, samples) float32 mV,
        sampling_freq)
      - ``device``, ``n_channels``, ``track_info``

    raw_counts=True returns each signal's integer ADC counts instead of
    float32 mV, plus a per-channel ``mv_per_count`` factor list (one
    (n_channels,) float32 vector per signal).  The on-disk ``.sig``
    layout is sample-major, so the count matrix is a ZERO-COPY view of
    the tar member bytes — no float materialization, half the host RAM,
    and the counts can ride the device link verbatim
    (``utils.transfer.upload_counts``) with the mV conversion fused into
    an on-device multiply.  This is the device-first import path: the
    reference (otb_file_handling.py:361-409) always materializes floats
    on the host because its consumers are host numpy.
    """
    otb4_path = str(otb4_path)
    if not os.path.exists(otb4_path):
        raise FileNotFoundError(f"OTB4 file not found: {otb4_path}")

    # stream members straight out of the tar: extractall round-trips the
    # full archive (1.7 GB at study scale) through disk before the first
    # byte is parsed — twice the IO for nothing
    try:
        tar = tarfile.open(otb4_path, 'r')
    except tarfile.ReadError:
        raise FileNotFoundError(
            f"Failed to extract {otb4_path}. File may be corrupted.")
    with tar:
        by_base = {os.path.basename(m.name): m
                   for m in tar.getmembers() if m.isfile()}

        def _member_bytes(base_name: str) -> bytes:
            fo = tar.extractfile(by_base[base_name])
            return fo.read()

        xml_files = [b for b in by_base if b.endswith('Tracks_000.xml')]
        if not xml_files:
            raise FileNotFoundError("No Tracks_000.xml found in archive.")
        import io as _io
        tracks = _parse_tracks_xml(
            _io.BytesIO(_member_bytes(xml_files[0])))

        device = tracks[0]['Device'].split(';')[0]
        n_channel = [int(t['NumberOfChannels']) for t in tracks]
        tot_ch = sum(n_channel)
        paths = [t['SignalStreamPath'] for t in tracks]

        sig_files = sorted(b for b in by_base if b.endswith('.sig'))
        if not sig_files:
            raise FileNotFoundError("No .sig files found in archive.")

        signals = []
        mv_per_count = []
        if device == 'Novecento+':
            # multiple int32 blocks; first .sig is typically empty
            for sig_name in sig_files[1:]:
                blocks = [j for j, p in enumerate(paths) if p == sig_name]
                if not blocks:
                    if verbose:
                        print(f"   Warning: No block found for {sig_name}")
                    continue
                n_ch = sum(n_channel[j] for j in blocks)
                raw = np.frombuffer(_member_bytes(sig_name),
                                    dtype=np.int32)
                slices, cur = [], 0
                for j in blocks:
                    slices.append((cur, cur + n_channel[j], tracks[j]))
                    cur += n_channel[j]
                try:
                    data, factors = _decode_sig(raw, n_ch, slices,
                                                raw_counts)
                except ValueError as e:
                    raise ValueError(
                        f"Data reshape failed for {sig_name}") from e
                fs = int(tracks[blocks[0]]['SamplingFrequency'])
                signals.append((sig_name, data, fs))
                mv_per_count.append(factors)
        else:
            raw = np.frombuffer(_member_bytes(sig_files[0]),
                                dtype=np.int16)
            if raw.size % tot_ch != 0:
                raise ValueError(
                    f"Data size {raw.size} not divisible by channel count "
                    f"{tot_ch}")
            slices, cur = [], 0
            for j, n in enumerate(n_channel):
                slices.append((cur, cur + n, tracks[j]))
                cur += n
            data, factors = _decode_sig(raw, tot_ch, slices, raw_counts)
            fs = int(tracks[0]['SamplingFrequency'])
            signals.append(("Signal", data, fs))
            mv_per_count.append(factors)

        out = {"device": device, "n_channels": tot_ch,
               "track_info": tracks, "signals": signals}
        if raw_counts:
            out["mv_per_count"] = mv_per_count
        return out


def write_otb4(otb4_path: str | Path, data: np.ndarray,
               sampling_freq: float, device: str = "MuoviPlus",
               gain: float = 1.0, adc_nbits: int = 16,
               adc_range: float = 2.4) -> Path:
    """Write a single-stream int16 OTB4 archive (inverse of
    :func:`read_otb4`'s int16 path, reference otb_file_handling.py:
    387-425).  Used to synthesize ADC-realistic cohorts that exercise
    the real importer (round-trip tested), and to re-export data.

    data : (n_channels, n_samples) — float32/64 values are taken as mV
        and converted to ADC counts via the inverse of the reader's
        ``raw * ADC_Range / 2**ADC_Nbits * 1000 / Gain`` (clipped to the
        int16 range); an int16 array is written verbatim as ADC counts.
    """
    otb4_path = Path(otb4_path)
    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError("data must be (n_channels, n_samples)")
    n_ch = int(data.shape[0])
    if data.dtype == np.int16:
        counts = data
    else:
        factor = adc_range / (2 ** adc_nbits) * 1000.0 / gain  # mV/count
        counts = np.clip(np.rint(data / factor), -32768,
                         32767).astype(np.int16)

    xml = (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        '<ArrayOfTrackInfo>\n'
        '  <TrackInfo>\n'
        f'    <Device>{device}</Device>\n'
        f'    <NumberOfChannels>{n_ch}</NumberOfChannels>\n'
        f'    <Gain>{gain}</Gain>\n'
        f'    <ADC_Nbits>{adc_nbits}</ADC_Nbits>\n'
        f'    <ADC_Range>{adc_range}</ADC_Range>\n'
        f'    <SamplingFrequency>{int(sampling_freq)}</SamplingFrequency>\n'
        '    <SignalStreamPath>Signal_000.sig</SignalStreamPath>\n'
        '  </TrackInfo>\n'
        '</ArrayOfTrackInfo>\n')

    tmp_dir = tempfile.mkdtemp(prefix="_tmp_otb4_write_")
    try:
        xml_path = os.path.join(tmp_dir, "Tracks_000.xml")
        with open(xml_path, "w") as f:
            f.write(xml)
        sig_path = os.path.join(tmp_dir, "Signal_000.sig")
        # reader reshapes (n_ch, -1) order='F' ⇒ write column-major
        counts.astype(np.int16).T.reshape(-1).tofile(sig_path)
        otb4_path.parent.mkdir(parents=True, exist_ok=True)
        with tarfile.open(otb4_path, "w") as tar:
            tar.add(xml_path, arcname="Tracks_000.xml")
            tar.add(sig_path, arcname="Signal_000.sig")
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return otb4_path


def _save_signal_to_csv(data: np.ndarray, time_axis: np.ndarray,
                        base_filename: str, output_dir: str,
                        channel_range: Tuple[int, int] | None = None,
                        combine_channels: bool = True,
                        output_files: list | None = None) -> str:
    output_files = output_files if output_files is not None else []
    n_ch = data.shape[0]
    offset = 0
    if channel_range is not None:
        start, end = channel_range
        if start < 0 or end > n_ch or start >= end:
            raise ValueError(
                f"Invalid channel_range ({start}, {end}). "
                f"Must be 0 <= start < end <= {n_ch}")
        data = data[start:end]
        offset = start
        n_ch = end - start

    if combine_channels:
        csv_data = {'Time_s': time_axis}
        for ch in range(n_ch):
            csv_data[f'Channel_{ch + offset + 1}'] = data[ch]
        out = os.path.join(output_dir, f'{base_filename}.csv')
        pd.DataFrame(csv_data).to_csv(out, index=False)
        output_files.append(out)
        return out

    first = None
    for ch in range(n_ch):
        out = os.path.join(output_dir,
                           f'{base_filename}_ch{ch + offset + 1}.csv')
        pd.DataFrame({'Time_s': time_axis,
                      f'Channel_{ch + offset + 1}': data[ch]}
                     ).to_csv(out, index=False)
        output_files.append(out)
        first = first or out
    return first


def import_otb4_to_csv(otb4_path: str, output_dir: str,
                       output_title: str | None = None,
                       combine_channels: bool = True,
                       channel_range: Tuple[int, int] | None = None,
                       verbose: bool = True) -> Dict:
    """Import an OTB4 file and export signals to CSV.

    Drop-in equivalent of reference otb_file_handling.py:178-444 (same
    metadata dict, filename scheme, and channel-range semantics).
    """
    os.makedirs(output_dir, exist_ok=True)
    base = output_title if output_title else Path(otb4_path).stem

    parsed = read_otb4(otb4_path, verbose=verbose)
    tot_ch = parsed["n_channels"]
    if channel_range is not None:
        start, end = channel_range
        if start < 0 or end > tot_ch or start >= end:
            raise ValueError(
                f"Invalid channel_range ({start}, {end}). Recording has "
                f"{tot_ch} channels. Must be 0 <= start < end <= {tot_ch}")
        n_exported = end - start
    else:
        n_exported = tot_ch

    output_files: list[str] = []
    fs = parsed["signals"][0][2]
    for sig_name, data, fs in parsed["signals"]:
        t = np.arange(data.shape[1]) / fs
        out = _save_signal_to_csv(data, t, base, output_dir,
                                  channel_range=channel_range,
                                  combine_channels=combine_channels,
                                  output_files=output_files)
        if verbose:
            print(f"   Saved: {os.path.basename(out)} "
                  f"({n_exported} channels, {data.shape[1] / fs:.2f}s)")

    return {
        'device': parsed["device"],
        'sampling_freq': fs,
        'n_channels': tot_ch,
        'n_channels_exported': n_exported,
        'channel_range': channel_range,
        'output_files': output_files,
        'track_info': parsed["track_info"],
    }


def show_graph(otb4_path_or_data, sampling_freq: float | None = None,
               channels: list[int] | None = None,
               max_seconds: float | None = 10.0,
               decimate_to: int = 4000,
               save_dir: str | Path | None = None,
               show: bool = False):
    """Stacked-trace signal viewer for an OTB4 recording.

    Analog of the reference's PyQt5/pyqtgraph ``show_graph()``
    (otb_file_handling.py:18-51), rebuilt on matplotlib so it runs
    headless.  Accepts either an .otb4 path or an already-parsed
    (n_channels, n_samples) array (+ ``sampling_freq``).  Traces are
    offset-stacked; long recordings are decimated for display only.
    """
    import matplotlib.pyplot as plt

    if isinstance(otb4_path_or_data, (str, Path)):
        parsed = read_otb4(otb4_path_or_data, verbose=False)
        name, data, fs = parsed["signals"][0]
    else:
        data = np.asarray(otb4_path_or_data)
        fs = float(sampling_freq or 1.0)
        name = "signal"
    if channels is not None:
        data = data[channels]
    if max_seconds is not None:
        data = data[:, :int(max_seconds * fs)]
    step = max(data.shape[1] // decimate_to, 1)
    view = data[:, ::step]
    t = np.arange(view.shape[1]) * step / fs

    spread = np.nanmedian(np.nanstd(view, axis=1)) * 6 or 1.0
    fig, ax = plt.subplots(figsize=(12, 0.35 * view.shape[0] + 2))
    for i, row in enumerate(view):
        ax.plot(t, row - np.nanmean(row) + i * spread, lw=0.5)
    ax.set_yticks(np.arange(view.shape[0]) * spread)
    ax.set_yticklabels([f"ch{c}" for c in
                        (channels or range(view.shape[0]))], fontsize=6)
    ax.set_xlabel("time [s]")
    ax.set_title(f"{name} — {view.shape[0]} channels @ {fs:g} Hz")
    if save_dir is not None:
        from mba_tpu.pipeline.visualizations import smart_save_fig
        smart_save_fig(save_dir, "OTB4 Signal Viewer", fig=fig)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax
