"""Document service drivers (local in-proc, replay).

Reference parity: packages/drivers/* behind the IDocumentService seam
(packages/loader/driver-definitions/src/storage.ts:59-262).
"""
